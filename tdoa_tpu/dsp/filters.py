"""FIR filtering, decimation, DC removal.

The reference approximates every filter with moving averages
(processor.go:270-296 lowpass, 384-394 highpass-as-difference, 412-434
notch cascade) — boxcars have terrible stopbands. Here filters are proper
windowed-sinc FIRs designed on the host (numpy, tiny) and applied on
device via ``lax.conv_general_dilated`` (cuDNN or an XLA fusion on the
GPU).
Strided convolution fuses decimation into the same pass.
"""

from __future__ import annotations

import functools
from typing import Union

import numpy as np
import jax
import jax.numpy as jnp

from tdoa_tpu.dsp.windows import hann
from tdoa_tpu.ops.cplx import C


def remove_dc(x: Union[jax.Array, C]) -> Union[jax.Array, C]:
    """Subtract the mean along the last axis (processor.go:299-319)."""
    if isinstance(x, C):
        return C(
            x.re - jnp.mean(x.re, axis=-1, keepdims=True),
            x.im - jnp.mean(x.im, axis=-1, keepdims=True),
        )
    return x - jnp.mean(x, axis=-1, keepdims=True)


@functools.lru_cache(maxsize=None)
def lowpass_taps(cutoff_hz: float, fs: float, num_taps: int = 129) -> np.ndarray:
    """Hann-windowed sinc lowpass, unity DC gain. ``num_taps`` odd."""
    if num_taps % 2 == 0:
        num_taps += 1
    fc = cutoff_hz / fs  # normalized (cycles/sample)
    k = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * fc * np.sinc(2 * fc * k)
    h *= hann(num_taps)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=None)
def bandpass_taps(
    lo_hz: float, hi_hz: float, fs: float, num_taps: int = 257
) -> np.ndarray:
    """Bandpass as difference of two lowpasses (linear phase preserved)."""
    return (
        lowpass_taps(hi_hz, fs, num_taps) - lowpass_taps(lo_hz, fs, num_taps)
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hilbert_taps(num_taps: int = 63) -> np.ndarray:
    """Hann-windowed FIR Hilbert transformer (−j·sgn(f) response), for the
    phasing-method SSB demodulator. ``num_taps`` odd; zero group delay
    relative to the unfiltered channel under 'SAME' convolution.

    Signs are pre-flipped for ``fir_filter``'s cross-correlation (lax.conv
    does not flip kernels), so ``fir_filter(sin, hilbert_taps())≈−cos``.
    """
    if num_taps % 2 == 0:
        num_taps += 1
    k = np.arange(num_taps) - (num_taps - 1) / 2
    h = np.where(k % 2 != 0, -2.0 / (np.pi * np.where(k == 0, 1.0, k)), 0.0)
    return (h * hann(num_taps)).astype(np.float32)


def _conv1d(x: jax.Array, taps: jax.Array, stride: int) -> jax.Array:
    """'SAME' 1-D convolution along the last axis with optional stride."""
    shape = x.shape
    n = shape[-1]
    xb = x.reshape(-1, 1, n)  # NCH
    k = taps.reshape(1, 1, -1)  # IOH → (out=1, in=1, width)
    y = jax.lax.conv_general_dilated(
        xb,
        k,
        window_strides=(stride,),
        padding="SAME",
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=jnp.float32,
        # Keep the float32 FIR out of TF32 on the GPU.
        precision=jax.lax.Precision.HIGHEST,
    )
    return y.reshape(*shape[:-1], y.shape[-1])


def fir_filter(
    x: Union[jax.Array, C], taps: np.ndarray, stride: int = 1
) -> Union[jax.Array, C]:
    """Apply a real-tap FIR along the last axis; ``stride`` > 1 decimates
    in the same fused pass. Planar complex filters each component."""
    t = jnp.asarray(taps, jnp.float32)
    if isinstance(x, C):
        return C(_conv1d(x.re, t, stride), _conv1d(x.im, t, stride))
    return _conv1d(x.astype(jnp.float32), t, stride)


def fir_decimate(
    x: Union[jax.Array, C],
    decim: int,
    fs: float,
    cutoff_frac: float = 0.45,
    num_taps: int = 129,
) -> Union[jax.Array, C]:
    """Anti-aliased decimation by ``decim`` (cutoff at ``cutoff_frac`` of
    the output Nyquist) in one strided convolution."""
    taps = lowpass_taps(cutoff_frac * fs / decim, fs, num_taps)
    return fir_filter(x, taps, stride=decim)


def resample_fft(x: jax.Array, n_out: int) -> jax.Array:
    """Resample a real signal to ``n_out`` samples by Fourier zero-pad /
    truncation (exact for bandlimited inputs, the audio-template case:
    a 44.1/48 kHz recording moving to the 2 Msps capture clock or the
    demodulated-audio rate — docs/audio-pattern-matching.md:31-47).

    Sample k of the output sits at time ``k·n_in/n_out`` of the input
    (both grids share t=0), so a template resampled with this keeps its
    absolute timing.
    """
    n_in = x.shape[-1]
    if n_out == n_in:
        return x.astype(jnp.float32)
    spec = jnp.fft.rfft(x.astype(jnp.float32), axis=-1)
    k_in, k_out = n_in // 2 + 1, n_out // 2 + 1
    if n_out > n_in:
        pad = [(0, 0)] * (spec.ndim - 1) + [(0, k_out - k_in)]
        spec = jnp.pad(spec, pad)
        # Upsampling splits an even input's Nyquist bin across the two
        # conjugate bins it unfolds into.
        if n_in % 2 == 0:
            spec = spec.at[..., k_in - 1].multiply(0.5)
    else:
        spec = spec[..., :k_out]
        if n_out % 2 == 0:
            # The output Nyquist bin must be real for a real irfft.
            spec = spec.at[..., -1].set(jnp.real(spec[..., -1]))
    return jnp.fft.irfft(spec, n=n_out, axis=-1) * (n_out / n_in)
