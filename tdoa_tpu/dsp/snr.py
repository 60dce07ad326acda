"""Spectral SNR estimation — analyzer.go's percentile-split semantics on a
proper Welch PSD.

The reference computes an O(N²) DFT (analyzer.go:322-337) over ≤16384
samples with a Blackman-Harris window, then calls the mean of the top-10%
bins "signal" and the bottom-50% "noise" (analyzer.go:239-265; the fast
analyzer uses bottom-40%, fast_analyzer.go:203-204). We keep those
percentile semantics (they define the calibrator's feedback signal) but
compute the PSD with the planar FFT over Welch-averaged windowed segments —
O(N·radix) and jittable.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import numpy as np
import jax
import jax.numpy as jnp

from tdoa_tpu.dsp.windows import blackman_harris, hann
from tdoa_tpu.ops import fft as mfft
from tdoa_tpu.ops.cplx import C

_WINDOWS = {"hann": hann, "blackman_harris": blackman_harris}


@functools.partial(jax.jit, static_argnames=("nfft", "window"))
def psd_welch(x: C, nfft: int = 8192, window: str = "blackman_harris") -> jax.Array:
    """Welch-averaged power spectral density over the last axis.

    Splits into ⌊N/nfft⌋ segments, windows, transforms (planar FFT), averages
    |X|². Returns [..., nfft] (two-sided, fftshift NOT applied).
    """
    n = x.re.shape[-1]
    if n < nfft:  # short capture: shrink to the largest pow2 that fits
        nfft = 1 << (n.bit_length() - 1)
    n_seg = max(n // nfft, 1)
    use = n_seg * nfft
    w = jnp.asarray(_WINDOWS[window](nfft))

    def seg_view(a):
        return a[..., :use].reshape(*a.shape[:-1], n_seg, nfft) * w

    xs = C(seg_view(x.re), seg_view(x.im))
    spec = mfft.fft(xs)
    return jnp.mean(spec.abs2(), axis=-2) / (jnp.sum(w**2) * nfft)


@functools.partial(
    jax.jit, static_argnames=("nfft", "window", "top_frac", "bottom_frac")
)
def spectral_snr(
    x: C,
    nfft: int = 8192,
    window: str = "blackman_harris",
    top_frac: float = 0.10,
    bottom_frac: float = 0.50,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """SNR via the analyzer's percentile split: mean(top ``top_frac`` bins)
    over mean(bottom ``bottom_frac`` bins), in dB.

    Returns (snr_db, signal_power, noise_power), each [...]-shaped.
    """
    psd = psd_welch(x, nfft=nfft, window=window)
    s = jnp.sort(psd, axis=-1)
    n_bins = psd.shape[-1]
    k_top = max(int(n_bins * top_frac), 1)
    k_bot = max(int(n_bins * bottom_frac), 1)
    sig = jnp.mean(s[..., n_bins - k_top :], axis=-1)
    noise = jnp.mean(s[..., :k_bot], axis=-1)
    snr_db = 10.0 * jnp.log10(jnp.maximum(sig, 1e-30) / jnp.maximum(noise, 1e-30))
    return snr_db, sig, noise
