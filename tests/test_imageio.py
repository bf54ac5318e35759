"""Image input/output without PIL or OpenCV: the PNG/PGM codec, the
synthetic-sequence renderer's parity with OpenCV, and import hygiene of
the main path."""

import ast
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from irotavg_tpu.utils.png import read_gray, write_png
from irotavg_tpu.utils.sequence import SequenceLoader, load_gray

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png_with_filters(px, ftypes):
    """Encode (H, W, C) uint8 pixels, filtering row y with ftypes[y]
    (the encoder side of PNG spec section 9)."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(np.int64)
    out = []
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        f = ftypes[y]
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8)
                   .tobytes())
        prior = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_every_filter_type(tmp_path, channels):
    rng = np.random.default_rng(channels)
    px = rng.integers(0, 256, (10, 13, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(px, [0, 1, 2, 3, 4] * 2))
    got = read_gray(str(path))
    if channels <= 2:
        np.testing.assert_array_equal(got, px[:, :, 0])
    else:
        rgb = px[:, :, :3].astype(np.uint32)
        lum = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470
               + rgb[..., 2] * 7471 + 0x8000) >> 16
        np.testing.assert_array_equal(got, lum)


def test_png_roundtrip_and_pil_crosscheck(tmp_path):
    """The writer's output reads back exactly, through this reader and
    through PIL; PIL-written gray and colour files decode as PIL's ``L``."""
    rng = np.random.default_rng(0)
    im = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    p = str(tmp_path / "own.png")
    write_png(p, im)
    np.testing.assert_array_equal(load_gray(p), im)
    Image = pytest.importorskip("PIL.Image")
    with Image.open(p) as back:
        np.testing.assert_array_equal(np.asarray(back), im)
    for mode, arr in [("L", im),
                      ("RGB", rng.integers(0, 256, (21, 17, 3), np.uint8)),
                      ("RGBA", rng.integers(0, 256, (21, 17, 4), np.uint8)),
                      ("LA", rng.integers(0, 256, (21, 17, 2), np.uint8))]:
        p = str(tmp_path / f"pil_{mode}.png")
        Image.fromarray(arr, mode).save(p)
        with Image.open(p) as ref:
            np.testing.assert_array_equal(read_gray(p),
                                          np.asarray(ref.convert("L")),
                                          err_msg=mode)


def test_pgm_reader(tmp_path):
    im = np.arange(6 * 7, dtype=np.uint8).reshape(6, 7) * 5
    p = tmp_path / "x.pgm"
    p.write_bytes(b"P5\n# a comment\n7 6\n255\n" + im.tobytes())
    np.testing.assert_array_equal(read_gray(str(p)), im)


@pytest.mark.parametrize("case", ["16bit", "interlaced", "palette", "jpeg",
                                  "pgm16"])
def test_unsupported_images_raise(tmp_path, case):
    p = tmp_path / "bad"
    if case == "jpeg":
        p.write_bytes(b"\xff\xd8\xff\xe0" + bytes(20))
    elif case == "pgm16":
        p.write_bytes(b"P5 2 2 65535\n" + bytes(8))
    else:
        depth, color, inter = {"16bit": (16, 0, 0), "interlaced": (8, 0, 1),
                               "palette": (8, 3, 0)}[case]
        body = struct.pack(">IIBBBBB", 2, 2, depth, color, 0, 0, inter)
        crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
        idat = zlib.compress(bytes(20))
        p.write_bytes(b"\x89PNG\r\n\x1a\n" + struct.pack(">I", 13) + b"IHDR"
                      + body + crc + struct.pack(">I", len(idat)) + b"IDAT"
                      + idat + bytes(4))
    with pytest.raises(ValueError):
        read_gray(str(p))


def test_seqgen_matches_opencv_render(monkeypatch):
    """The numpy renderer against OpenCV's primitives on one frame of the
    same scene (noise, blur and lens distortion on): mean |diff| < 0.25
    grey levels and at most 0.1% of pixels off by more than 2 (warp-mask
    edge pixels, where OpenCV's fixed-point weights round the other
    way)."""
    cv2 = pytest.importorskip("cv2")
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import seqgen

    kw = dict(n_frames=1, seed=3, noise_sigma=6.0, blur_sigma=0.6,
              k1=-0.28, k2=0.07)
    ours = seqgen.make_ring_sequence(**kw)[0][0]

    def texture(rng, size=400):
        tex = cv2.GaussianBlur(rng.integers(60, 200, (size, size), np.uint8),
                               (0, 0), 1.2)
        for _ in range(60):
            q = rng.integers(10, size - 30, 2)
            w, h = rng.integers(6, 30, 2)
            cv2.rectangle(tex, (int(q[0]), int(q[1])),
                          (int(q[0] + w), int(q[1] + h)),
                          int(rng.integers(0, 255)), -1)
        for _ in range(40):
            c = tuple(int(v) for v in rng.integers(15, size - 15, 2))
            cv2.circle(tex, c, int(rng.integers(3, 12)),
                       int(rng.integers(0, 255)), -1)
        return tex

    def warp_quad(canvas, tex, H):
        size = canvas.shape[::-1]
        warped = cv2.warpPerspective(tex, H, size, flags=cv2.INTER_LINEAR)
        mask = cv2.warpPerspective(np.full(tex.shape, 255, np.uint8), H, size)
        canvas[mask > 128] = warped[mask > 128]

    def remap(img, xs, ys, replicate):
        assert replicate
        out = cv2.remap(img, xs, ys, cv2.INTER_LINEAR,
                        borderMode=cv2.BORDER_REPLICATE)
        return out.astype(np.float64), None

    monkeypatch.setattr(seqgen, "_texture", texture)
    monkeypatch.setattr(seqgen, "_warp_quad", warp_quad)
    monkeypatch.setattr(seqgen, "_bilinear", remap)
    monkeypatch.setattr(seqgen, "_blur",
                        lambda im, s: cv2.GaussianBlur(im, (0, 0), s))
    monkeypatch.setattr(
        seqgen, "_homography",
        lambda src, dst: cv2.getPerspectiveTransform(
            np.float32(src), np.float32(dst)))
    ref = seqgen.make_ring_sequence(**kw)[0][0]

    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.mean() < 0.25, d.mean()
    assert (d > 2).mean() <= 1e-3, (d > 2).mean()


_HYGIENE = r"""
import sys
sys.modules["PIL"] = sys.modules["cv2"] = None
sys.path[:0] = [{repo!r}, {tests!r}]
import os, pkgutil, importlib
import numpy as np
import irotavg_tpu
for m in pkgutil.walk_packages(irotavg_tpu.__path__, "irotavg_tpu."):
    if not m.name.endswith("_native"):     # the built ctypes library
        importlib.import_module(m.name)
import chip_smoke, seqgen
from irotavg_tpu.utils import SequenceLoader, load_gray, save_png
frames, K, R = seqgen.make_ring_sequence(n_frames=3, size=(96, 64), fx=80.0,
                                         seed=1, blur_sigma=0.6, k1=-0.1)
d = {out!r}
for i, im in enumerate(frames):
    save_png(os.path.join(d, "%06d.png" % i), im)
back = [load_gray(p) for _, p in SequenceLoader(d, ".png")]
assert len(back) == 3
assert all((a == b).all() for a, b in zip(frames, back))
print("hygiene ok")
"""

# what the main path may import besides the standard library and itself
_ALLOWED_ROOTS = {"jax", "numpy", "scipy", "irotavg_tpu", "seqgen",
                  "ref_impl", "synth"}
_MAIN_PATH = ["irotavg_tpu/app/irotavg.py", "irotavg_tpu/app/irotavg_batch.py",
              "irotavg_tpu/app/l1_irls.py", "tests/seqgen.py", "chip_smoke.py"]


def test_main_path_needs_no_pil_or_opencv(tmp_path):
    """With PIL and cv2 unimportable, every package module imports and a
    rendered sequence round-trips through save_png / SequenceLoader /
    load_gray."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = _HYGIENE.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                           out=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "hygiene ok" in r.stdout


@pytest.mark.parametrize("path", _MAIN_PATH)
def test_main_path_imports_only_stdlib_jax_numpy_scipy(path):
    """Every import statement in the main-path files, top level or inside
    a function, names the standard library, JAX, numpy, scipy or the
    repository itself."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    bad = roots - _ALLOWED_ROOTS - set(sys.stdlib_module_names)
    assert not bad, bad
