"""Device byte histogram (256 bins).

Replacement for the reference's tiled GPU histogram
(``TornadoKernels.histogramTiledKernel:89-100`` + CPU reduce in
``GpuFrequencyService.java:123-129``).  Instead of translating the
tile/sub-histogram/reduce structure, the histogram is expressed as a matrix
product via a rank decomposition: with ``b = 16·hi + lo``,

    hist[hi, lo] = Σ_i onehot16(hi_i) ⊗ onehot16(lo_i)  =  OH_hiᵀ @ OH_lo

so the whole 256-bin histogram is one ``(16, N) × (N, 16)`` matmul — ~32
compare-ops plus 256 MACs per byte, no scatters, no atomics, race-free by
construction.  Whether XLA:GPU fuses the one-hot operands into the
contraction or materializes them is read from ``memory_analysis()`` on the
card; the plain ``bincount``/scatter-add form is the A/B candidate.

Accumulation is exact on every backend, TF32 included: the one-hots are f32
0 and 1 (exact in TF32's 10-bit mantissa), the products accumulate in f32,
and each tile contributes at most ``TILE`` counts (< 2²⁴); partials are
converted to int32 before the final sum.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

#: elements per accumulation tile — f32 matmul stays integer-exact (< 2^24)
TILE = 1 << 22


def _hist_tile(x: jnp.ndarray) -> jnp.ndarray:
    """(n,) uint8/int32 → (256,) int32 histogram of one tile."""
    x = x.astype(jnp.int32)
    hi = x >> 4
    lo = x & 15
    r = jnp.arange(16, dtype=jnp.int32)
    oh_hi = (hi[:, None] == r[None, :]).astype(jnp.float32)  # (n,16)
    oh_lo = (lo[:, None] == r[None, :]).astype(jnp.float32)  # (n,16)
    # default precision is exact (module docstring); the scope name is the
    # TF32 audit's allow-list key (tests/test_ops.py)
    with jax.named_scope("hist_onehot_dot"):
        h16 = jax.lax.dot_general(
            oh_hi, oh_lo,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (16,16): [hi, lo]
    return h16.reshape(256).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("tile",))
def histogram_device(data: jnp.ndarray, valid_len: jnp.ndarray, tile: int = TILE) -> jnp.ndarray:
    """int32[256] histogram of ``data[:valid_len]``.

    ``data`` is the padded (static-shape) chunk as uint8; bytes at or beyond
    ``valid_len`` are masked out by redirecting them to bin 0 and subtracting
    the pad count afterwards (cheaper than a select inside the matmul fusion).
    """
    n = data.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    masked = jnp.where(idx < valid_len, data.astype(jnp.int32), 0)
    if n <= tile:
        hist = _hist_tile(masked)
    else:
        ntiles = (n + tile - 1) // tile
        pad = ntiles * tile - n
        if pad:
            masked = jnp.concatenate([masked, jnp.zeros(pad, jnp.int32)])
        tiles = masked.reshape(ntiles, tile)
        # lax.map over tiles keeps each contraction's partial sums < 2^24
        hist = jax.lax.map(_hist_tile, tiles).sum(axis=0, dtype=jnp.int32)
        hist = hist.at[0].add(-pad)
    # remove the pad-redirected zeros
    return hist.at[0].add(-(n - valid_len).astype(jnp.int32))


def histogram_np(data: np.ndarray) -> np.ndarray:
    return np.bincount(np.asarray(data, np.uint8), minlength=256).astype(np.int64)
