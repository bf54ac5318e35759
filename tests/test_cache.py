"""Where the persistent compilation cache lives."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
sys.path.insert(0, {repo!r})
from irotavg_tpu.utils.cache import enable_persistent_cache
used = enable_persistent_cache()
import jax
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 2.0 + 1.0)(jax.numpy.ones(3)).block_until_ready()
print(used)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env):
    r = subprocess.run([sys.executable, "-c", _PROBE.format(repo=REPO)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip().splitlines()[-2:]


def test_cache_honours_env_var(tmp_path):
    target = tmp_path / "jaxcache"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(target))
    used, configured = _probe(env)
    assert used == configured == str(target)
    assert target.is_dir() and any(target.iterdir())


def test_cache_defaults_to_repo_dir():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    used, configured = _probe(env)
    assert used == configured == os.path.join(REPO, ".jax_cache")
