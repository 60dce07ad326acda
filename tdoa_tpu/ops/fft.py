"""Planar FFT: Cooley–Tukey four-step as batched DFT matmuls.

A power-of-two FFT of length N = N1·N2·… is decomposed into stages of
radix ≤ 256, and each stage is a **dense DFT-matrix matmul**, with
twiddle rotations fused as elementwise work between stages:

    x[(N1,N2)] --DFT_N1 along axis -2--> ·twiddle--> FFT_N2 along -1
              --> transpose(-1,-2) --> reshape(N)

Complexity is O(N·Σradix) MACs instead of O(N log N) adds — a
FLOP-for-structure trade: every op is a large, static-shaped matmul.
Complex values are planar (ops/cplx.py): one complex matmul = 4 real
matmuls.

Precision: the ``"f32"`` path pins every matmul to
``Precision.HIGHEST``. Without the pin a float32 matmul may run in TF32
on the GPU, whose 10-bit mantissa is as coarse as bf16's 8 for the
phase-slope delay refinement. ``"bf16"`` keeps bf16 operands with f32
accumulation at the backend's default precision.

Twiddles are computed on device from integer index products reduced
mod N *in integer arithmetic* before converting to angle, so phase error
stays at f32 rounding even for multi-million-point transforms.

Replaces: processor.go's O(N²) single-threaded DFT (processor.go:515-536).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from tdoa_tpu.ops.cplx import C

# Largest direct-DFT radix: larger bases trade matmul FLOPs for fewer
# recursion levels and therefore fewer inter-stage transposes.
_BASE = 256


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) parts of the n-point DFT matrix W[j,k] = e^{-2πi jk/n},
    computed in float64 and rounded once to float32."""
    j, k = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    ang = -2.0 * np.pi * ((j * k) % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _split(n: int) -> Tuple[int, int]:
    """Factor n = N1·N2 with N1 ≤ _BASE as large as possible."""
    n1 = min(_BASE, n)
    while n % n1:
        n1 >>= 1
    return n1, n // n1


def _twiddle(n1: int, n2: int) -> C:
    """tw[k1, n2] = e^{-2πi k1 n2 / (n1·n2)}, angles from exact int mod."""
    n = n1 * n2
    k1 = jax.lax.broadcasted_iota(jnp.int32, (n1, n2), 0)
    j2 = jax.lax.broadcasted_iota(jnp.int32, (n1, n2), 1)
    prod = (k1 * j2) % n  # < n ≤ 2^26 — exact in int32
    ang = prod.astype(jnp.float32) * jnp.float32(-2.0 * np.pi / n)
    return C(jnp.cos(ang), jnp.sin(ang))


def _mm_cast(precision: str):
    """Operand dtype for the DFT matmuls. ``bf16`` runs with f32
    accumulation — relative error ~1e-2 per stage, fine for coarse peak
    search, not for the phase-slope path. Default f32."""
    return jnp.bfloat16 if precision == "bf16" else jnp.float32


def _mm_precision(precision: str):
    """Matmul precision: HIGHEST on the f32 path (never TF32), the
    backend default for bf16 operands."""
    return None if precision == "bf16" else jax.lax.Precision.HIGHEST


def _dft_last(x: C, n: int, precision: str) -> C:
    """Direct DFT along the last axis via matmul (n ≤ _BASE)."""
    cr, si = _dft_mats(n)
    t = _mm_cast(precision)
    wr, wi = jnp.asarray(cr, t), jnp.asarray(si, t)
    xr, xi = x.re.astype(t), x.im.astype(t)
    mm = functools.partial(jnp.matmul, preferred_element_type=jnp.float32,
                           precision=_mm_precision(precision))
    yr = mm(xr, wr) - mm(xi, wi)
    yi = mm(xr, wi) + mm(xi, wr)
    return C(yr, yi)


def _fft_last(x: C, n: int, precision: str) -> C:
    """FFT along the last axis, any power-of-two n."""
    if n <= _BASE:
        return _dft_last(x, n, precision)
    n1, n2 = _split(n)
    batch = x.re.shape[:-1]
    x = C(x.re.reshape(*batch, n1, n2), x.im.reshape(*batch, n1, n2))
    # DFT_N1 along axis -2: contract the DFT matrix with the n1 axis.
    cr, si = _dft_mats(n1)
    t = _mm_cast(precision)
    wr, wi = jnp.asarray(cr, t), jnp.asarray(si, t)
    ein = functools.partial(jnp.einsum, "kj,...jm->...km",
                            preferred_element_type=jnp.float32,
                            precision=_mm_precision(precision))

    def dft_axis2(r, i):
        # [..., n1, n2] with D[k1, j1]: einsum over j1.
        r, i = r.astype(t), i.astype(t)
        return C(ein(wr, r) - ein(wi, i), ein(wi, r) + ein(wr, i))

    y = dft_axis2(x.re, x.im)
    y = y * _twiddle(n1, n2)
    y = _fft_last(y, n2, precision)  # recurse along the last axis
    # Output index is N1·k2 + k1 → transpose (k1, k2) → (k2, k1), flatten.
    y = C(jnp.swapaxes(y.re, -1, -2), jnp.swapaxes(y.im, -1, -2))
    return C(y.re.reshape(*batch, n), y.im.reshape(*batch, n))


def fft(x: C, n: Optional[int] = None, precision: str = "f32") -> C:
    """Planar FFT along the last axis. ``n`` (power of two) zero-pads or
    truncates, numpy-style."""
    ln = x.re.shape[-1]
    if n is None:
        n = ln
    if n & (n - 1):
        raise ValueError(f"fft length must be a power of two, got {n}")
    if n != ln:
        if n > ln:
            pad = [(0, 0)] * (x.re.ndim - 1) + [(0, n - ln)]
            x = C(jnp.pad(x.re, pad), jnp.pad(x.im, pad))
        else:
            x = C(x.re[..., :n], x.im[..., :n])
    return _fft_last(x, n, precision)


def ifft(x: C, n: Optional[int] = None, precision: str = "f32") -> C:
    """Planar inverse FFT along the last axis (conjugation trick)."""
    ln = x.re.shape[-1]
    if n is None:
        n = ln
    y = fft(C(x.re, -x.im), n, precision)
    inv = jnp.float32(1.0 / n)
    return C(y.re * inv, -y.im * inv)


def fft_real(x: jax.Array, n: Optional[int] = None, precision: str = "f32") -> C:
    """FFT of a real signal (planar output, full spectrum)."""
    return fft(
        C(x.astype(jnp.float32), jnp.zeros_like(x, jnp.float32)), n, precision
    )


def fftfreq(n: int) -> np.ndarray:
    """Host-side fftfreq (cycles/sample), matching np.fft.fftfreq."""
    return np.fft.fftfreq(n).astype(np.float32)
