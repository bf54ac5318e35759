"""The gated best-2 matcher (ops/hamming.best2) against a host XOR+popcount
oracle, and its shape, padding and empty-input behaviour."""

import jax.numpy as jnp
import numpy as np
import pytest
from ref_impl import best2 as oracle_best2

from irotavg_tpu.ops.hamming import (
    BIG, GATES, best2, hamming_matrix, make_colft, make_rowf, unpack_pm1,
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    n1, n2 = 200, 300   # deliberately not multiples of 128
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    # plant near-duplicates so best/second-best are non-trivial
    d2[10] = d1[0]
    d2[11] = d1[0] ^ np.uint32(1)
    meta = {
        "valid1": rng.random(n1) > 0.1,
        "valid2": rng.random(n2) > 0.1,
        "node1": rng.integers(0, 12, n1),
        "node2": rng.integers(0, 12, n2),
        "x1": rng.uniform(0, 640, n1), "y1": rng.uniform(0, 480, n1),
        "x2": rng.uniform(0, 640, n2), "y2": rng.uniform(0, 480, n2),
        "oct1": rng.integers(0, 8, n1), "oct2": rng.integers(0, 8, n2),
    }
    return d1, d2, meta


def _features(gate, m):
    n1, n2 = len(m["x1"]), len(m["x2"])
    if gate in ("none", "node"):
        return (make_rowf(m["valid1"], node=m["node1"]),
                make_colft(m["valid2"], node=m["node2"]))
    if gate == "local":
        return (make_rowf(m["valid1"], x=m["x1"], y=m["y1"],
                          octave=m["oct1"],
                          th=np.full(n1, 60.0, np.float32)),
                make_colft(m["valid2"], x=m["x2"], y=m["y2"],
                           octave=m["oct2"]))
    # epipolar variants: small integer line coefficients through integer
    # points keep the gate exact in f32, so the oracle's mask cannot round
    # differently from the device's
    rng = np.random.default_rng(3)
    a = rng.integers(-1, 2, n2)
    b = rng.integers(-1, 2, n2)
    c = rng.integers(-500, 500, n2)
    return (make_rowf(m["valid1"], node=m["node1"], x=np.round(m["x1"]),
                      y=np.round(m["y1"]), th=np.full(n1, 900.0)),
            make_colft(m["valid2"], node=m["node2"], a=a, b=b, c=c))


def _assert_equal(got, want, tag):
    np.testing.assert_array_equal(np.asarray(got[0]), want[0],
                                  err_msg=f"d1 [{tag}]")
    np.testing.assert_array_equal(np.asarray(got[1]), want[1],
                                  err_msg=f"d2 [{tag}]")
    np.testing.assert_array_equal(np.asarray(got[2]), want[2],
                                  err_msg=f"idx [{tag}]")


@pytest.mark.parametrize("gate", GATES)
def test_best2_matches_popcountoracle_best2(problem, gate):
    """Exact equality with XOR+popcount on every gate type."""
    d1, d2, m = problem
    rowf, colft = _features(gate, m)
    got = best2(unpack_pm1(d1), unpack_pm1(d2).T, rowf, colft, gate)
    want = oracle_best2(gate, d1, d2, rowf, colft)
    assert (want[2] >= 0).sum() > 20, "the gate left too few candidates"
    _assert_equal(got, want, gate)


def test_pm1_distance_identity(problem):
    """128 - 0.5*<±1, ±1> equals the XOR+popcount Hamming distance."""
    d1, d2, _ = problem
    bits1 = unpack_pm1(d1).astype(jnp.float32)
    bits2 = unpack_pm1(d2).astype(jnp.float32)
    D_dot = 128.0 - 0.5 * (bits1 @ bits2.T)
    D_ref = hamming_matrix(jnp.asarray(d1), jnp.asarray(d2))
    np.testing.assert_array_equal(np.asarray(D_dot).astype(np.int32),
                                  np.asarray(D_ref))


@pytest.mark.parametrize("n1,n2", [(1, 1), (129, 127), (257, 3)])
def test_best2_odd_shapes(n1, n2):
    rng = np.random.default_rng(n1 * 1000 + n2)
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    rowf = make_rowf(np.ones(n1, bool))
    colft = make_colft(np.ones(n2, bool))
    got = best2(unpack_pm1(d1), unpack_pm1(d2).T, rowf, colft, "none")
    assert [g.shape for g in got] == [(n1,)] * 3
    _assert_equal(got, oracle_best2("none", d1, d2, rowf, colft), f"{n1}x{n2}")
    if n2 == 1:     # a single candidate leaves no second best
        assert (np.asarray(got[1]) == BIG).all()


def test_best2_invalid_rows_have_no_match(problem):
    d1, d2, m = problem
    valid1 = m["valid1"].copy()
    valid1[::3] = False
    rowf = make_rowf(valid1)
    colft = make_colft(m["valid2"])
    d_1, d_2, idx = (np.asarray(v) for v in best2(
        unpack_pm1(d1), unpack_pm1(d2).T, rowf, colft, "none"))
    assert (idx[~valid1] == -1).all()
    assert (d_1[~valid1] == BIG).all() and (d_2[~valid1] == BIG).all()
    assert (idx[valid1] >= 0).all()


@pytest.mark.parametrize("empty", ["rows", "cols"])
def test_best2_empty_side(empty):
    rng = np.random.default_rng(0)
    n1, n2 = (0, 5) if empty == "rows" else (5, 0)
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    got = best2(unpack_pm1(d1), unpack_pm1(d2).T,
                make_rowf(np.ones(n1, bool)), make_colft(np.ones(n2, bool)),
                "none")
    assert [g.shape for g in got] == [(n1,)] * 3
    assert (np.asarray(got[2]) == -1).all()
    assert (np.asarray(got[0]) == BIG).all()


def test_best2_rejects_unknown_gate(problem):
    d1, d2, m = problem
    with pytest.raises(ValueError):
        best2(unpack_pm1(d1), unpack_pm1(d2).T, make_rowf(m["valid1"]),
              make_colft(m["valid2"]), "nearest")
