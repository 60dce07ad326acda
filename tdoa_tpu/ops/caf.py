"""Cross Ambiguity Function: joint delay-Doppler estimation.

Long coherent integrations decorrelate when the emitter (or a receiver
clock) moves: a relative frequency offset ν rotates the segment-to-
segment cross-spectrum phase, and the plain sum (ops/corr.py) washes
out. The CAF searches (τ, ν) jointly — the standard tool for moving-
emitter TDOA/FDOA that the reference lacks entirely (its integration
plan, snr_analysis.go:83-88, silently assumes zero Doppler).

Implementation ("slow-time DFT"): segment cross-spectra are
kept per-segment instead of summed, so Doppler compensation becomes a
phase ramp over the *segment index* — one small matmul against a steering
matrix turns S per-segment spectra into D Doppler-compensated coherent
sums, reusing every FFT:

    caf[d, f] = Σ_s cross[s, f] · exp(−j2π ν_d s T_seg)

Validity: within-segment rotation must be small (|ν|·T_seg ≲ 0.1), so
the unambiguous Doppler span is ±1/(2·T_seg) — pick seg_len to cover the
expected dynamics (docs: a 100 m/s emitter at 100 MHz is ~±33 Hz).

Cost over plain correlation: the [S, F] per-pair spectra live in device memory
(S·F·8 bytes per pair) and the finish stage runs once per Doppler bin.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tdoa_tpu.ops import fft as mfft
from tdoa_tpu.ops.cplx import C, exp_i
from tdoa_tpu.ops.corr import (
    _lag_window,
    _phase_slope_refine,
    next_pow2,
    resolve_seg,
)
from tdoa_tpu.ops.peaks import parabolic_peak


class CafResult(NamedTuple):
    delay: jax.Array  # [m] samples (sub-sample, at the best Doppler)
    doppler_hz: jax.Array  # [m] best Doppler bin (sub-bin refined)
    peak_value: jax.Array  # [m]
    surface: jax.Array  # [m, n_doppler, 2*max_lag+1] |CAF| map


def _segment_cross_spectra(x: C, pair_idx, seg_len, fft_len, precision):
    """Per-segment cross spectra, kept unsummed: C [m, S, F]."""
    n_st, n = x.re.shape
    n_seg = n // seg_len

    def one(s, _):
        sl = lambda a: jax.lax.dynamic_slice(a, (0, s * seg_len), (n_st, seg_len))
        xf = mfft.fft(C(sl(x.re), sl(x.im)), fft_len, precision)
        xj = C(xf.re[pair_idx[:, 1]], xf.im[pair_idx[:, 1]])
        xi = C(xf.re[pair_idx[:, 0]], xf.im[pair_idx[:, 0]])
        cross = xj.mul_conj(xi)
        return s + 1, (cross.re, cross.im)

    _, (cr, ci) = jax.lax.scan(one, 0, None, length=n_seg)
    # [S, m, F] → [m, S, F]
    return C(jnp.swapaxes(cr, 0, 1), jnp.swapaxes(ci, 0, 1)), n_seg


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_lag", "seg_len", "n_doppler", "sample_rate", "fft_precision",
        "weighting",
    ),
)
def caf_pairs(
    x: C,  # [n_st, N]
    pair_idx: jax.Array,  # [m, 2]
    sample_rate: float,
    max_lag: int = 1024,
    seg_len: int = 1 << 15,
    n_doppler: int = 32,
    doppler_span_hz: Optional[float] = None,
    eps: float = 1e-3,
    fft_precision: str = "f32",
    weighting: str = "phat",
) -> CafResult:
    """Delay-Doppler surface for every station pair.

    ``doppler_span_hz`` defaults to the full unambiguous span
    ±1/(2·T_seg). Doppler sign convention: positive ν means station
    ``j``'s signal is received *up-shifted* relative to station ``i``'s.

    ``weighting="phat"`` whitens per segment (sharp delay peaks for
    pairwise station×station surfaces, both sides noisy).
    ``weighting="none"`` keeps the raw cross-power — the true matched
    filter, correct when one side is a NOISELESS template
    (pipeline/audio_match.py): whitening there hands the 90+% empty
    bins' segment-edge leakage — common to every channel and anchored
    at lag 0 — enough votes to bury near-zero true delays (measured: a
    3.25-sample truth reported as the clip-bound 1.0).
    """
    n = x.re.shape[1]
    seg_len_r, fft_len = resolve_seg(n, max_lag, seg_len, None)
    t_seg = seg_len_r / sample_rate
    if doppler_span_hz is None:
        doppler_span_hz = 1.0 / (2.0 * t_seg)
    nu = jnp.linspace(-doppler_span_hz, doppler_span_hz, n_doppler)

    cross, n_seg = _segment_cross_spectra(
        x, pair_idx, seg_len_r, fft_len, fft_precision
    )  # [m, S, F]

    # PHAT whitening per segment (flat spectrum ⇒ sharp delay peak),
    # then an energy weight per segment: plain per-segment whitening
    # would hand noise-only segments (emitter silent) the same unit vote
    # as high-SNR ones in the slow-time Doppler sum, while whitening by
    # the segment-averaged magnitude blunts/biases the delay peak.
    if weighting == "phat":
        mag = jnp.sqrt(cross.abs2())
        d = mag + eps * jnp.mean(mag, axis=-1, keepdims=True) + 1e-30
        seg_mag = jnp.mean(mag, axis=-1, keepdims=True)  # [m, S, 1]
        seg_w = seg_mag / (jnp.mean(seg_mag, axis=1, keepdims=True) + 1e-30)
        white = C(cross.re / d * seg_w, cross.im / d * seg_w)
    elif weighting == "none":
        # Plain cross-power: bins vote by energy (segments implicitly
        # too), the matched-filter weighting.
        white = cross
    else:
        raise ValueError(f"caf weighting must be 'phat' or 'none', "
                         f"got {weighting!r}")

    # Slow-time steering: a pair with relative Doppler ν has cross-
    # spectrum phase advancing by +2π ν T_seg per segment (positive ν =
    # station j up-shifted); steer[d, s] = exp(−j2π ν_d s T_seg)
    # derotates it so the sum is coherent at ν_d = ν.
    s_idx = jnp.arange(n_seg, dtype=jnp.float32)
    theta = -2.0 * jnp.pi * nu[:, None] * s_idx[None, :] * t_seg
    steer = exp_i(theta)  # C [D, S]

    # caf[m, D, F] = Σ_s steer[D, s] · white[m, s, F] — two real matmuls
    # per component, contracting the segment axis. HIGHEST keeps the
    # float32 contractions out of TF32 on the GPU.
    hi = jax.lax.Precision.HIGHEST
    f32 = jnp.float32
    ein = functools.partial(jnp.einsum, preferred_element_type=f32,
                            precision=hi)

    def steer_mm(wr, wi):
        rr = ein("ds,msf->mdf", steer.re, wr)
        ri = ein("ds,msf->mdf", steer.re, wi)
        ir = ein("ds,msf->mdf", steer.im, wr)
        ii = ein("ds,msf->mdf", steer.im, wi)
        return C(rr - ii, ri + ir)

    caf_spec = steer_mm(white.re, white.im)  # [m, D, F]
    r = mfft.ifft(caf_spec)  # correlation per Doppler bin
    win = jnp.sqrt(
        _lag_window(r.re, max_lag) ** 2 + _lag_window(r.im, max_lag) ** 2
    )  # [m, D, W]

    m, ndop, w = win.shape
    flat = win.reshape(m, ndop * w)
    idx = jnp.argmax(flat, axis=-1)
    di = idx // w
    # Parabolic refinement in both axes around the joint peak.
    lag_pos, peak = parabolic_peak(
        jnp.take_along_axis(win, di[:, None, None].repeat(w, -1), axis=1)[:, 0, :]
    )
    delay = lag_pos - jnp.float32(max_lag)
    # Sub-sample refinement on the Doppler-compensated coherent spectrum
    # at the winning bin — built from the *unwhitened* cross-spectra so
    # the |C|² weighting in the phase-slope fit favors coherent in-band
    # bins (whitened bins would vote uniformly, noise included).
    steer_best = C(steer.re[di], steer.im[di])  # [m, S]
    br = (ein("ms,msf->mf", steer_best.re, cross.re)
          - ein("ms,msf->mf", steer_best.im, cross.im))
    bi = (ein("ms,msf->mf", steer_best.re, cross.im)
          + ein("ms,msf->mf", steer_best.im, cross.re))
    delay, _, _ = _phase_slope_refine(C(br, bi), jnp.round(delay), fft_len,
                                      max_lag)
    dop_slice = jnp.take_along_axis(
        win, (idx % w)[:, None, None].repeat(ndop, 1), axis=2
    )[:, :, 0]
    dop_pos, _ = parabolic_peak(dop_slice)
    dop_step = (2.0 * doppler_span_hz) / (n_doppler - 1)
    doppler = -doppler_span_hz + dop_pos * dop_step
    return CafResult(
        delay=delay, doppler_hz=doppler, peak_value=peak, surface=win
    )
