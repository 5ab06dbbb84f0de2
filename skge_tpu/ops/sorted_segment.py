"""Sort + banded one-hot matmul segment-sum — the gradient scatter as
sorting plus small dense matmuls instead of per-row atomics.

The iid-corruption step's aggregation scatter-adds (T, D) occurrence rows
into an (R, D) table. Pipeline: (1) sort ids with an iota payload;
(2) gather rows into sorted order; (3) for each CHUNK of sorted rows,
which covers a narrow contiguous band of the table, build a (band, chunk)
one-hot and matmul it against the chunk's rows — the matmul performs the
duplicate combining — then add the (band, D) block into the table at the
band's dynamic offset. FLOPs = T*band*D*2*terms, tiny when band ~=
4*chunk*R/T.

Precision: fp32 operands are split into bf16 terms by INTEGER mantissa
truncation (bitcast + mask — XLA folds an f32->bf16->f32 convert
round-trip away as excess precision, silently zeroing the residual, so
the split must not use converts). 3 terms carry 8+8+8 >= 24 mantissa
bits: products against a 0/1 one-hot are exact and accumulation is fp32,
so the result is a pure fp32 summation, closer to the fp64 truth than an
fp32 scatter whose additions land in arbitrary order.

Exactness guard: a chunk whose VALID ids span more than `band` rows
(possible for skewed id distributions; never for the uniform corruption
stream at the default geometry) flips a flag and the whole call falls
back to the XLA scatter via `lax.cond` — bit-identical semantics, never
silent drops. Out-of-range ids (negative or >= num_rows) are dropped,
matching `.at[].add(mode='drop')` on non-negative ids (NO NumPy wrap on
negatives).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_MASK_HI = 0xFFFF0000


def _split3(x: jnp.ndarray):
    """Exact 3-term bf16 split of fp32 via integer mantissa truncation.

    bf16(hi) is exact (8-bit mantissa by construction); each residual is
    an exact fp32 subtraction. Converts are NOT used for the rounding —
    XLA's excess-precision simplification folds convert(convert(x,bf16),
    f32) back to x, which would zero the residuals.
    """
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    h1 = jax.lax.bitcast_convert_type(u & jnp.uint32(_MASK_HI), jnp.float32)
    r1 = x - h1
    u2 = jax.lax.bitcast_convert_type(r1, jnp.uint32)
    h2 = jax.lax.bitcast_convert_type(u2 & jnp.uint32(_MASK_HI), jnp.float32)
    r2 = r1 - h2
    return (
        h1.astype(jnp.bfloat16),
        h2.astype(jnp.bfloat16),
        r2.astype(jnp.bfloat16),
    )


@functools.partial(
    jax.jit, static_argnames=("num_rows", "chunk", "band")
)
def segment_sum_sorted(
    indices: jnp.ndarray,   # (T,) int32
    values: jnp.ndarray,    # (T, D) float32
    num_rows: int,
    chunk: int = 2048,
    band: int = 1024,
) -> jnp.ndarray:
    """Sum `values` rows into a (num_rows, D) fp32 table by `indices`.

    Semantics match `jnp.zeros((num_rows, D)).at[idx].add(vals,
    mode='drop')` for in-range ids, with out-of-range ids (including
    negatives) dropped; summation is pure fp32 (one tree per band).
    Falls back to the XLA scatter inside `lax.cond` when a chunk's valid
    ids span more than `band` table rows.
    """
    if values.dtype != jnp.float32:
        raise TypeError(
            f"segment_sum_sorted is fp32-only, got {values.dtype}"
        )
    t, d = values.shape
    indices = indices.astype(jnp.int32)
    pad = (-t) % chunk
    if pad:
        indices = jnp.concatenate(
            [indices, jnp.full((pad,), num_rows, jnp.int32)]
        )
        values = jnp.concatenate(
            [values, jnp.zeros((pad, d), values.dtype)]
        )
    tt = t + pad
    band = max(1, min(band, num_rows))

    sid, pos = jax.lax.sort(
        (indices, jnp.arange(tt, dtype=jnp.int32)), num_keys=1
    )
    vs = jnp.take(values, pos, axis=0)
    nch = tt // chunk
    ids_c = sid.reshape(nch, chunk)
    v_c = vs.reshape(nch, chunk, d)
    bases = jnp.clip(ids_c[:, 0], 0, max(0, num_rows - band))
    off_all = ids_c - bases[:, None]
    valid = jnp.logical_and(ids_c >= 0, ids_c < num_rows)
    overflow = jnp.any(jnp.logical_and(off_all >= band, valid))

    def banded(_):
        iota = jnp.arange(band, dtype=jnp.int32)

        def body(table, arg):
            ids, v, base = arg
            oh = (
                (ids - base)[None, :] == iota[:, None]
            ).astype(jnp.bfloat16)                       # (band, chunk)
            h1, h2, h3 = _split3(v)
            bb = jax.lax.dot(
                oh, jnp.concatenate([h1, h2, h3], axis=1),
                preferred_element_type=jnp.float32,
            )                                            # (band, 3D)
            blk = bb[:, :d] + bb[:, d:2 * d] + bb[:, 2 * d:]
            zero = jnp.zeros((), base.dtype)
            cur = jax.lax.dynamic_slice(table, (base, zero), (band, d))
            return (
                jax.lax.dynamic_update_slice(
                    table, cur + blk, (base, zero)
                ),
                0,
            )

        tab, _ = jax.lax.scan(
            body,
            jnp.zeros((num_rows, d), jnp.float32),
            (ids_c, v_c, bases),
        )
        return tab

    def fallback(_):
        safe = jnp.where(sid < 0, num_rows, sid)  # match no-wrap dropping
        return jnp.zeros((num_rows, d), jnp.float32).at[safe].add(
            vs, mode="drop"
        )

    return jax.lax.cond(overflow, fallback, banded, 0)


@functools.partial(jax.jit, static_argnames=("num_rows",))
def segment_sum_onehot(
    indices: jnp.ndarray,   # (T,) int32
    values: jnp.ndarray,    # (T, F) float32
    num_rows: int,
) -> jnp.ndarray:
    """Whole-table one-hot matmul segment-sum — no sort, no band.

    For SMALL destination tables with WIDE rows (TransR's per-relation
    (d, d) projection gradients: num_rows ~ 10^3, F = d^2 ~ 10^4+) the
    banding machinery is pure overhead. Here the whole aggregation is ONE
    (num_rows, T) x (T, 3F) matmul: the one-hot is exact in bf16, values
    take the exact 3-term mantissa split, and the matmul does the
    duplicate combining (closer to fp64 than the fp32 scatter, same as the
    banded form).

    Memory: the one-hot is (num_rows, T) bf16 — callers gate on
    num_rows * T (ops/aggregate.py uses <= 64 MiB).
    """
    if values.dtype != jnp.float32:
        raise TypeError(
            f"segment_sum_onehot is fp32-only, got {values.dtype}"
        )
    t, f = values.shape
    indices = indices.astype(jnp.int32)
    iota = jnp.arange(num_rows, dtype=jnp.int32)
    # out-of-range ids (drop semantics) match no row of the iota
    oh = (indices[None, :] == iota[:, None]).astype(jnp.bfloat16)
    # three separate dots, NOT one dot against concat([h1,h2,h3], axis=1):
    # the (T, 3F) bf16 concat materializes ~650 MB of pure data movement at
    # the TransR shape (measured 3.1 ms of a 43 ms step); the one-hot lhs
    # re-read is 13 MB
    h1, h2, h3 = _split3(values)
    acc = jax.lax.dot(oh, h1, preferred_element_type=jnp.float32)
    acc = acc + jax.lax.dot(oh, h2, preferred_element_type=jnp.float32)
    return acc + jax.lax.dot(oh, h3, preferred_element_type=jnp.float32)
