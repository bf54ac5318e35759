"""Hamming distance between 256-bit descriptors, and gated best-2 matching.

Replaces the scalar popcount loops of the reference (FORB::distance,
third_party/DBoW2/DBoW2/FORB.cpp:81-101; descriptorDistance,
src/ViewGraph.cpp:106-122, inside findORBMatches* :125-569) two ways:

* :func:`hamming_matrix` — the literal XOR+popcount over 8 words, a dense
  (K1, K2) integer matrix.
* :func:`best2` — the matchers' hot path.  Descriptors are unpacked once
  per frame to ±1 rows, and the Hamming distance becomes the exact integer
  identity ``h = 128 - 0.5 * <a, b>``: one bf16 matrix product with f32
  accumulation, then a gated (validity / vocab-node / search-window /
  epipolar) per-row best, second-best and argmin.  XLA fuses the gate and
  the reductions into the product's consumer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

BIG = 10_000.0

GATES = ("none", "node", "local", "epipolar", "epipolar_nonode")


@functools.partial(jax.jit, inline=True)
def popcount32(x):
    """Per-lane popcount of uint32 (SWAR bit-twiddle, 5 integer ops)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


@functools.partial(jax.jit, inline=True)
def hamming_matrix(d1, d2):
    """(K1, K2) int32 Hamming distances for (K1, 8), (K2, 8) uint32 words."""
    x = jnp.bitwise_xor(d1[:, None, :], d2[None, :, :])  # (K1, K2, 8)
    return jnp.sum(popcount32(x), axis=-1).astype(jnp.int32)


def unpack_pm1(desc, dtype=jnp.bfloat16):
    """(N, 8) uint32 descriptor words -> (N, 256) ±1 rows.

    bit b of word w maps to column ``32*w + b``; <a, b> over ±1 vectors
    equals ``256 - 2*hamming``, exactly representable in bf16/f32.
    """
    desc = jnp.asarray(desc, jnp.uint32)
    bits = (desc[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    bits = bits.reshape(desc.shape[0], 256)
    return (2.0 * bits.astype(jnp.float32) - 1.0).astype(dtype)


# rowf columns: 0 valid, 1 node, 2 gx/x1, 3 gy/y1, 4 octave, 5 th/radius
# colft rows:   0 valid, 1 node, 2 x2, 3 y2, 4 octave, 5 a, 6 b, 7 c


def gate_mask(gate, rowf, colft):
    """(N1, N2) bool candidate mask.  ``rowf`` is (N1, 8) and ``colft`` is
    (8, N2), so both broadcasts are along their natural axis."""
    mask = (rowf[:, 0:1] > 0) & (colft[0:1, :] > 0)
    if gate == "node":
        mask &= rowf[:, 1:2] == colft[1:2, :]
    elif gate == "local":
        r = rowf[:, 5:6]
        mask &= jnp.abs(colft[2:3, :] - rowf[:, 2:3]) <= r
        mask &= jnp.abs(colft[3:4, :] - rowf[:, 3:4]) <= r
        o1 = rowf[:, 4:5]
        o2 = colft[4:5, :]
        mask &= (o2 >= jnp.maximum(o1 - 2, 0)) & \
                (o2 <= jnp.minimum(o1 + 2, 7))
    elif gate in ("epipolar", "epipolar_nonode"):
        if gate == "epipolar":
            mask &= rowf[:, 1:2] == colft[1:2, :]
        a, b, c = colft[5:6, :], colft[6:7, :], colft[7:8, :]
        num = a * rowf[:, 2:3] + b * rowf[:, 3:4] + c
        den = a * a + b * b
        # num^2/den < th  <=>  num^2 < th*den (den >= 0; den==0 -> reject)
        mask &= num * num < rowf[:, 5:6] * den
    return mask


def best2(bits1, bits2t, rowf, colft, gate: str):
    """Per-row (best_dist, second_dist, best_idx) over gated columns.

    bits1: (N1, 256) ±1; bits2t: (256, N2) ±1 (transposed); rowf: (N1, 8);
    colft: (8, N2).  Distances are exact integers in f32 (``BIG`` where no
    candidate passes the gate); ``best_idx`` is the first minimising column,
    or -1 when the row has no candidate.
    """
    if gate not in GATES:
        raise ValueError(f"unknown gate {gate!r}")
    n1, n2 = bits1.shape[0], bits2t.shape[1]
    if n2 == 0:
        return (jnp.full((n1,), BIG, jnp.float32),
                jnp.full((n1,), BIG, jnp.float32),
                jnp.full((n1,), -1, jnp.int32))
    # ±1 operands and integer sums of at most 256 terms are exact in a bf16
    # product with f32 accumulation, so every caller may compare distances
    # for equality.
    dot = jax.lax.dot(bits1.astype(jnp.bfloat16), bits2t.astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    D = jnp.where(gate_mask(gate, rowf, colft), 128.0 - 0.5 * dot, BIG)
    i1 = jnp.argmin(D, axis=1).astype(jnp.int32)
    d1 = jnp.min(D, axis=1)
    cols = jnp.arange(D.shape[1], dtype=jnp.int32)
    d2 = jnp.min(jnp.where(cols[None, :] == i1[:, None], BIG, D), axis=1)
    return d1, d2, jnp.where(d1 >= BIG, -1, i1)


def make_rowf(valid, node=None, x=None, y=None, octave=None, th=None):
    """Assemble the (N, 8) per-row feature block (f32)."""
    n = valid.shape[0]
    z = jnp.zeros((n,), jnp.float32)
    cols = [
        jnp.asarray(valid, jnp.float32),
        z if node is None else jnp.asarray(node, jnp.float32),
        z if x is None else jnp.asarray(x, jnp.float32),
        z if y is None else jnp.asarray(y, jnp.float32),
        z if octave is None else jnp.asarray(octave, jnp.float32),
        z if th is None else jnp.asarray(th, jnp.float32),
        z, z,
    ]
    return jnp.stack(cols, axis=1)


def make_colft(valid, node=None, x=None, y=None, octave=None,
               a=None, b=None, c=None):
    """Assemble the (8, N) per-column feature block (f32, transposed)."""
    n = valid.shape[0]
    z = jnp.zeros((n,), jnp.float32)
    rows = [
        jnp.asarray(valid, jnp.float32),
        z if node is None else jnp.asarray(node, jnp.float32),
        z if x is None else jnp.asarray(x, jnp.float32),
        z if y is None else jnp.asarray(y, jnp.float32),
        z if octave is None else jnp.asarray(octave, jnp.float32),
        z if a is None else jnp.asarray(a, jnp.float32),
        z if b is None else jnp.asarray(b, jnp.float32),
        z if c is None else jnp.asarray(c, jnp.float32),
    ]
    return jnp.stack(rows, axis=0)
