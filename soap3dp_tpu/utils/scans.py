"""Layout-safe large-array scans (cumsum / cummax / bounded nonzero).

Written for the system's first accelerator target, whose XLA lowering
of big 1-D cumulative ops padded a trailing dimension of 1 to its
(8, 128) tile, so a 2^27-element cumsum materialized a multi-GB buffer
and the compile aborted — on the repeat-genome human-scale run, where
the candidate-compaction budget K legitimately reaches 10^8. Whether
plain jnp.cumsum / jnp.nonzero are as good on the GPU is not measured
yet (ROADMAP §3 item 4); these helpers are plain JAX and run anywhere.

These helpers reshape to a (rows, 1024) matrix, scan the minor axis
(wide trailing dim -> sane tiling at any size), then recursively scan
the per-row carries. jnp.nonzero has the same pathology through its
internal cumsum, so nonzero_prefix builds the bounded index list from
cumsum_1d + one scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_W = 1024  # minor-axis width; bucketed sizes are powers of two >= 256


def cumsum_1d(x: jax.Array) -> jax.Array:
    """Inclusive cumsum of a 1-D integer array, any length."""
    n = x.shape[0]
    if n <= _W:
        return jnp.cumsum(x)
    rows = -(-n // _W)
    pad = rows * _W - n
    xp = jnp.concatenate([x, jnp.zeros(pad, x.dtype)]) if pad else x
    m = xp.reshape(rows, _W)
    inner = jnp.cumsum(m, axis=1)
    tails = inner[:, -1]
    carry = cumsum_1d(tails) - tails          # exclusive row offsets
    return (inner + carry[:, None]).reshape(-1)[:n]


def cummax_1d(x: jax.Array) -> jax.Array:
    """Inclusive cummax of a 1-D integer array, any length."""
    n = x.shape[0]
    if n <= _W:
        return jax.lax.cummax(x)
    rows = -(-n // _W)
    pad = rows * _W - n
    if pad:
        fill = jnp.full(pad, jnp.iinfo(x.dtype).min, x.dtype)
        x = jnp.concatenate([x, fill])
    m = x.reshape(rows, _W)
    inner = jax.lax.cummax(m, axis=1)
    tails = inner[:, -1]
    inc = cummax_1d(tails)
    lo = jnp.full(1, jnp.iinfo(x.dtype).min, x.dtype)
    carry = jnp.concatenate([lo, inc[:-1]])   # exclusive row maxima
    return jnp.maximum(inner, carry[:, None]).reshape(-1)[:n]


def nonzero_prefix(mask: jax.Array, size: int) -> jax.Array:
    """First `size` indices where mask is True, ascending; -1 padded.

    Equivalent to jnp.nonzero(mask, size=size, fill_value=-1)[0] but
    without the giant internal 1-D cumsum."""
    n = mask.shape[0]
    rank = cumsum_1d(mask.astype(jnp.int32)) - 1
    tgt = jnp.where(mask & (rank < size), rank, size)
    out = jnp.full(size + 1, -1, jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop")
    return out[:size]
