"""Numeric primitives: circular correlation, gradient aggregation."""

from skge_tpu.ops.circulant import ccorr, cconv
from skge_tpu.ops.aggregate import (
    DenseGrads,
    UniqueGrads,
    segment_mean_dense,
    segment_mean_unique,
)

__all__ = [
    "ccorr",
    "cconv",
    "DenseGrads",
    "UniqueGrads",
    "segment_mean_dense",
    "segment_mean_unique",
]
