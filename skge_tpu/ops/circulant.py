"""Circular correlation / convolution — HolE's core op.

Reference semantics (skge/util.py ~15-20, SURVEY.md §2.1 #4):
    cconv(a, b) = ifft(fft(a) * fft(b)).real
    ccorr(a, b) = ifft(conj(fft(a)) * fft(b)).real

Design: inputs are real, so we use `rfft`/`irfft`, halving the
spectrum width and FLOPs versus the reference's complex FFT. The spectral
elementwise product fuses under XLA; everything is batched over leading dims
so the FFT runs as one batched kernel rather than a Python loop.

These also provide the adjoint identities used for scoring against ALL
entities as a single matmul (SURVEY.md §3.4):
    score(s, p, o) = <r_p, ccorr(e_s, e_o)> = <e_o, cconv(e_s, r_p)>
                                            = <e_s, ccorr(r_p, e_o)>

A DFT-as-matmul formulation (7 real (B,d)x(d,d) matmuls) computes the
same thing; it was tried against XLA's FFT, gave no win and needs exact
('highest') matmul precision, so the rfft path stays.
"""

from __future__ import annotations

import jax.numpy as jnp


def cconv(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Circular convolution along the last axis, batched over leading dims."""
    n = a.shape[-1]
    return jnp.fft.irfft(jnp.fft.rfft(a, n=n) * jnp.fft.rfft(b, n=n), n=n)


def ccorr(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Circular correlation along the last axis, batched over leading dims."""
    n = a.shape[-1]
    return jnp.fft.irfft(
        jnp.conj(jnp.fft.rfft(a, n=n)) * jnp.fft.rfft(b, n=n), n=n
    )
