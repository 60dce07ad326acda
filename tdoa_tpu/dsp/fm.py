"""FM quadrature demodulation + decimation.

Capability of rtl_fm.c's discriminator pipeline (polar_discriminant at
rtl_fm.c:427-434, fm_demod 517-544, decimation 302-392), which the
reference project documents as the aid for correlation (README.md:3-7) but
never wired into its processor. Rebuilt as:

- the discriminator is the *pairwise-product* form — phase increments
  come from ``x[n]·conj(x[n−1])`` so there is no running state to
  unwrap, and the whole signal demodulates as one vectorized
  elementwise pass (atan2) on planar complex;
- decimation is a strided windowed-sinc FIR (dsp/filters.py), which XLA
  fuses with the discriminator's elementwise work.

Demodulated audio is the preferred correlation domain for FM signals:
receiver LO offsets become DC shifts (instead of rotating phasors) and
the audio bandwidth concentrates all correlation energy.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

from tdoa_tpu.dsp.filters import fir_decimate, fir_filter, hilbert_taps, remove_dc
from tdoa_tpu.ops.cplx import C, exp_i


def fm_modulate(
    audio: jax.Array,
    sample_rate: float,
    deviation_hz: float = 25_000.0,
) -> C:
    """Synthesize the unit-amplitude complex-baseband FM signal a given
    audio program generates: ``f_inst = k_f·audio`` around the carrier
    (the prediction step of the reference's audio-pattern-matching plan,
    docs/audio-pattern-matching.md:41-47 — documented there but never
    built). Inverse of :func:`fm_demodulate` up to the decimation filter.

    ``audio`` must already be at ``sample_rate`` (see
    :func:`tdoa_tpu.dsp.filters.resample_fft`); full scale ±1 maps to
    ±``deviation_hz``. Phase integrates from 0 at sample 0.
    """
    phase = (
        2.0 * jnp.pi * deviation_hz / sample_rate
    ) * jnp.cumsum(audio.astype(jnp.float32), axis=-1)
    return exp_i(phase)


def fm_discriminate(x: C, sample_rate: float = 1.0) -> jax.Array:
    """Instantaneous frequency in Hz (per-sample phase increment).

    ``d[n] = angle(x[n]·conj(x[n−1]))·fs/2π``; d[0] = 0. The pairwise
    product needs no phase unwrapping — increments are already in (−π, π].
    Shape-preserving along the last axis.
    """
    p_re = x.re[..., 1:] * x.re[..., :-1] + x.im[..., 1:] * x.im[..., :-1]
    p_im = x.im[..., 1:] * x.re[..., :-1] - x.re[..., 1:] * x.im[..., :-1]
    inc = jnp.arctan2(p_im, p_re)  # radians/sample
    inc = jnp.pad(inc, [(0, 0)] * (inc.ndim - 1) + [(1, 0)])
    return inc * jnp.float32(sample_rate / (2.0 * jnp.pi))


@jax.named_scope("fm_demod_decimate")
def fm_demodulate(
    x: C,
    sample_rate: float,
    decim: int = 16,
    deviation_hz: Optional[float] = None,
    num_taps: int = 129,
) -> jax.Array:
    """Full demod chain: discriminator → DC removal → anti-aliased
    decimation. Returns real audio at ``sample_rate/decim``.

    DC removal strips the receiver LO frequency offset (a constant
    instantaneous-frequency bias), standing in for rtl_fm's dc_block
    (rtl_fm.c:613). ``deviation_hz`` normalizes audio to ≈±1 full scale.
    The name scope lets profiler traces attribute the stage's device
    time to it.
    """
    d = fm_discriminate(x, sample_rate)
    d = remove_dc(d)
    if deviation_hz:
        d = d / jnp.float32(deviation_hz)
    if decim > 1:
        d = fir_decimate(d, decim, sample_rate, num_taps=num_taps)
    return d


def am_demodulate(
    x: C,
    sample_rate: float,
    decim: int = 16,
    num_taps: int = 129,
) -> jax.Array:
    """Envelope (AM) demodulation: anti-aliased complex decimation, then
    magnitude, then DC removal (strips the carrier level).

    Capability of rtl_fm.c's ``am_demod`` (rtl_fm.c:546-561), which takes
    the magnitude of the decimated I/Q; the carrier DC is removed here
    the way rtl_fm's dc_block option does (rtl_fm.c:613).
    """
    if decim > 1:
        x = fir_decimate(x, decim, sample_rate, num_taps=num_taps)
    env = jnp.sqrt(x.re * x.re + x.im * x.im)
    return remove_dc(env)


def _hilbert_len(fs_audio: float, transition_hz: float) -> int:
    """Hilbert FIR length whose transition band (≈4·fs/T for the Hann
    window) is ``transition_hz``, clamped odd in [255, 4095]."""
    n = int(4.0 * fs_audio / transition_hz)
    n = max(255, min(4095, n))
    return n | 1


def ssb_demodulate(
    x: C,
    sample_rate: float,
    sideband: str = "usb",
    decim: int = 16,
    num_taps: int = 129,
    hilbert_transition_hz: float = 150.0,
) -> jax.Array:
    """Single-sideband demodulation by the phasing method.

    Capability of rtl_fm.c's ``usb_demod``/``lsb_demod``
    (rtl_fm.c:563-587), rebuilt correctly: the reference's I±Q sum is a
    45°-phasing approximation that does NOT reject the opposite sideband
    (both sidebands survive it at equal magnitude). The true phasing
    method is ``I ∓ H{Q}`` with a Hilbert transformer H — USB audio is
    ``(I − H{Q})/2``, LSB ``(I + H{Q})/2`` — implemented as one more
    FIR pass. Decimation runs first so the Hilbert FIR operates at the
    audio rate; its length scales with that rate so the rejection holds
    down to ``hilbert_transition_hz`` regardless of ``decim``.
    """
    if sideband not in ("usb", "lsb"):
        raise ValueError(f"sideband must be 'usb' or 'lsb', got {sideband!r}")
    if decim > 1:
        x = fir_decimate(x, decim, sample_rate, num_taps=num_taps)
    hq = fir_filter(
        x.im, hilbert_taps(_hilbert_len(sample_rate / decim,
                                        hilbert_transition_hz))
    )
    audio = (x.re - hq if sideband == "usb" else x.re + hq) * jnp.float32(0.5)
    return remove_dc(audio)
