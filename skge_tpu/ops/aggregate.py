"""Duplicate-index gradient aggregation — the `grad_sum_matrix` equivalent.

Reference semantics (skge/util.py ~30, SURVEY.md §3.1): per-occurrence row
gradients are AVERAGED over duplicate indices (sum divided by occurrence
count), not summed. Rows touched only by masked-out occurrences (padding or
non-violating pairs) must receive NO update at all — no AdaGrad accumulation
and no post-constraint projection.

Two implementations:

- `segment_mean_unique`: batch-local. Sort-based `jnp.unique(size=T)` over
  the static-size occurrence list, then `segment_sum`. Touches only O(batch)
  rows; this is the scalable path for device-resident tables (no dense
  table-sized temporaries).
- `segment_mean_dense`: scatter-adds into full-table accumulators. Simpler
  for XLA SPMD when the table is row-sharded across a mesh (the scatter and
  the division stay sharded); used by the multi-device path.

Both return enough information for a sparse optimizer update that exactly
matches the reference's "filter violations first, then average" order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class UniqueGrads(NamedTuple):
    """Batch-local averaged gradients.

    uidx:  (T,) unique row ids; padding slots hold `num_rows` (out of range,
           dropped by `.at[].set(mode='drop')` scatters).
    grads: (T, ...) averaged gradient per unique row (zero for padding).
    count: (T,) number of unmasked occurrences (0 => row must not be updated).
    """

    uidx: jnp.ndarray
    grads: jnp.ndarray
    count: jnp.ndarray


class DenseGrads(NamedTuple):
    """Full-table averaged gradients.

    grads: same shape as the parameter table; averaged gradient (zero rows
           where untouched).
    count: (num_rows,) unmasked occurrence counts (0 => untouched).
    """

    grads: jnp.ndarray
    count: jnp.ndarray


class FactoredOcc(NamedTuple):
    """Occurrence list whose per-occurrence gradients are LOW-RANK sums of
    outer products `sum_f us[f][t] (x) vs[f][t]` of a matrix-valued
    parameter row (RESCAL's W: rank 2 — `es (x) dq + dr (x) eo`).

    Stored factored so the (T, d, d) per-occurrence tensor is formed only
    where it is consumed: `segment_outer_mean_dense` builds the summed
    outer product as the update operand of one scatter-add.

    idx:    (T,) int row ids (>= num_rows = dropped padding).
    us, vs: tuples of (T, d) left/right factors, one pair per rank term.
            Grads are PREMASKED (violation-weighted sums), as in
            training.pairwise_grads_shared.
    count:  (T,) structural occurrence counts for the duplicate-index
            averaging.
    """

    idx: jnp.ndarray
    us: Tuple[jnp.ndarray, ...]
    vs: Tuple[jnp.ndarray, ...]
    count: jnp.ndarray


def _bmask(mask: jnp.ndarray, ndim: int) -> jnp.ndarray:
    """Reshape (T,) mask to broadcast against (T, ...) grads."""
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


# flattened feature width above which segment_mean_dense scatters grads and
# counts separately instead of via the fused count channel (see below)
_WIDE_ROW_THRESHOLD = 4096


def segment_mean_unique(
    indices: jnp.ndarray,
    grads: jnp.ndarray,
    mask: jnp.ndarray,
    num_rows: int,
    premasked: bool = False,
) -> UniqueGrads:
    """Average per-occurrence `grads` over duplicate `indices`.

    indices: (T,) int row ids (concatenated over all roles/slots).
    grads:   (T, ...) per-occurrence gradients.
    mask:    (T,) float; masked-out occurrences contribute neither gradient
             nor count (reference filters violating pairs BEFORE building the
             index list — skge/hole.py ~70).
    premasked: when True, `grads` are already mask-weighted SUMS over several
             structural occurrences and `mask` holds the (possibly >1)
             occurrence COUNTS — the fused fast path (see
             training.pairwise_grads_fused).
    """
    t = indices.shape[0]
    uidx, inv = jnp.unique(
        indices, size=t, fill_value=num_rows, return_inverse=True
    )
    inv = inv.reshape(-1)
    count = jax.ops.segment_sum(mask, inv, num_segments=t)
    g = grads if premasked else grads * _bmask(mask, grads.ndim).astype(grads.dtype)
    gsum = jax.ops.segment_sum(g, inv, num_segments=t)
    gavg = gsum / _bmask(jnp.maximum(count, 1.0), gsum.ndim)
    return UniqueGrads(uidx=uidx, grads=gavg, count=count)


def segment_outer_mean_dense(occ: FactoredOcc, num_rows: int) -> DenseGrads:
    """`segment_mean_dense` for factored rank-1 occurrence gradients.

    Sums `u[t] (x) v[t]` into the (num_rows, d, d) table by `occ.idx` and
    divides by the summed occurrence counts.
    """
    t, d = occ.us[0].shape
    dt = occ.us[0].dtype
    outers = sum(
        u[:, :, None] * v[:, None, :] for u, v in zip(occ.us, occ.vs)
    ).reshape(t, -1)
    gsum = (
        jnp.zeros((num_rows, d * d), dt)
        .at[occ.idx]
        .add(outers, mode="drop")
        .reshape(num_rows, d, d)
    )
    count = jnp.zeros((num_rows,), dt).at[occ.idx].add(
        occ.count.astype(dt), mode="drop"
    )
    gavg = gsum / _bmask(jnp.maximum(count, 1.0), gsum.ndim)
    return DenseGrads(grads=gavg, count=count)


def segment_mean_dense(
    indices: jnp.ndarray,
    grads: jnp.ndarray,
    mask: jnp.ndarray,
    num_rows: int,
    premasked: bool = False,
    backend: str = "xla",
) -> DenseGrads:
    """Same semantics as `segment_mean_unique` but into full-table arrays.

    Gradients and occurrence counts are scattered in ONE fused scatter-add
    (counts ride as an extra trailing channel), so each table takes one
    scatter instead of two.

    backend='xla' is XLA's scatter-add; 'sorted' is the sort + banded
    one-hot matmul of ops/sorted_segment.py (float32 only; other dtypes
    take the scatter).
    """
    if backend not in ("xla", "sorted"):
        raise ValueError(f"unknown segment backend {backend!r}")
    g = grads if premasked else grads * _bmask(mask, grads.ndim).astype(grads.dtype)
    t = indices.shape[0]
    feat_shape = grads.shape[1:]
    flat = g.reshape(t, -1)
    sorted_ok = backend == "sorted" and flat.dtype == jnp.float32
    if flat.shape[1] >= _WIDE_ROW_THRESHOLD:
        # wide rows (e.g. RESCAL's (d, d) relation slices): the fused count
        # channel would copy the whole (T, F) block into a (T, F+1) concat,
        # which costs more than the second scatter it saves. Scatter grads
        # and counts separately.
        if flat.dtype == jnp.float32 and num_rows * t * 2 <= 64 * 1024 * 1024:
            # small destination table (e.g. TransR's (n_r, d, d) projection
            # tables): ONE whole-table one-hot matmul with the exact 3-term
            # bf16 mantissa split
            from skge_tpu.ops.sorted_segment import segment_sum_onehot

            gsum = segment_sum_onehot(indices, flat, num_rows)
        elif sorted_ok:
            from skge_tpu.ops.sorted_segment import segment_sum_sorted

            # wide rows triple via the 3-term mantissa split, so shrink the
            # chunk/band to keep the (band, 3F) block transient bounded
            # (~70 MB at F=22500, band=256)
            gsum = segment_sum_sorted(
                indices, flat, num_rows, chunk=512,
                band=min(512, max(1, num_rows)),
            )
        else:
            gsum = jnp.zeros((num_rows, flat.shape[1]), g.dtype).at[
                indices
            ].add(flat, mode="drop")
        gsum = gsum.reshape((num_rows,) + feat_shape)
        count = jnp.zeros((num_rows,), g.dtype).at[indices].add(
            mask.astype(g.dtype), mode="drop"
        )
        gavg = gsum / _bmask(jnp.maximum(count, 1.0), gsum.ndim)
        return DenseGrads(grads=gavg, count=count)
    aug = jnp.concatenate([flat, mask.astype(g.dtype)[:, None]], axis=1)
    if sorted_ok:
        from skge_tpu.ops.sorted_segment import segment_sum_sorted

        table = segment_sum_sorted(indices, aug, num_rows)
    else:
        table = jnp.zeros((num_rows, aug.shape[1]), g.dtype).at[indices].add(
            aug, mode="drop"
        )
    count = table[:, -1]
    gsum = table[:, :-1].reshape((num_rows,) + feat_shape)
    gavg = gsum / _bmask(jnp.maximum(count, 1.0), gsum.ndim)
    return DenseGrads(grads=gavg, count=count)
