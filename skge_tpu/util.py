"""Host-side utility functions with the reference `skge/util.py` surface.

These are the NumPy/SciPy helpers a scikit-kge user expects to find
(SURVEY.md §2.1 #4): `cconv`, `ccorr`, `grad_sum_matrix`, `unzip_triples`,
`to_tensor`, `init_nvecs`. The JAX compute path uses the JAX versions in
`skge_tpu.ops`; these exist for API parity, host-side preprocessing, and
spectral initialization.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def cconv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Circular convolution (skge/util.py ~15), batched on leading dims."""
    return np.fft.irfft(
        np.fft.rfft(a, a.shape[-1]) * np.fft.rfft(b, b.shape[-1]),
        a.shape[-1],
    )


def ccorr(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Circular correlation (skge/util.py ~20), batched on leading dims."""
    return np.fft.irfft(
        np.conj(np.fft.rfft(a, a.shape[-1])) * np.fft.rfft(b, b.shape[-1]),
        a.shape[-1],
    )


def grad_sum_matrix(idx: Sequence[int]):
    """(unique_idx, summing matrix, counts) — skge/util.py ~30.

    The returned sparse CSR matrix M satisfies `M @ stacked_grads` = per-
    unique-row gradient SUM; dividing by `n` gives the reference's AVERAGE.
    """
    from scipy.sparse import csr_matrix

    idx = np.asarray(idx)
    uidx, inv = np.unique(idx, return_inverse=True)
    data = np.ones(idx.size)
    m = csr_matrix((data, (inv, np.arange(idx.size))), shape=(uidx.size, idx.size))
    n = np.asarray(m.sum(axis=1)).reshape(-1, 1)
    return uidx, m, n


def unzip_triples(xys, with_ys: bool = False):
    """Split [(s, o, p), ...] or [((s, o, p), y), ...] — (s, o, p) order
    (skge/util.py ~50)."""
    if with_ys:
        xs = np.array([x for x, _ in xys], dtype=np.int64)
        ys = np.array([y for _, y in xys], dtype=np.float64)
        return xs[:, 0], xs[:, 1], xs[:, 2], ys
    xs = np.array(list(xys), dtype=np.int64)
    return xs[:, 0], xs[:, 1], xs[:, 2]


def to_tensor(xs, ys, sz) -> List:
    """List of per-relation sparse frontal slices (skge/util.py ~65)."""
    from scipy.sparse import lil_matrix

    T = [lil_matrix((sz[0], sz[1])) for _ in range(sz[2])]
    for (s, o, p), y in zip(xs, ys):
        T[p][s, o] = y
    return T


def init_nvecs(xs, ys, sz, rank: int, with_T: bool = False):
    """Spectral init: leading eigenvectors of sum_k (T_k + T_k^T)
    (skge/util.py ~80)."""
    from scipy.sparse.linalg import eigsh

    T = to_tensor(xs, ys, sz)
    T = [t.tocsr() for t in T]
    S = sum(t + t.T for t in T)
    _, E = eigsh(S.tocsc(), rank)
    E = np.asarray(E)
    E = E[:, ::-1]  # order by descending eigenvalue
    if with_T:
        return E, T
    return E
