"""Batched FFT cross-correlation with GCC weighting — the hot path.

Replaces the reference's O(maxLag·N) time-domain search
(processor.go:646-736, ~4×10¹⁰ MACs per pair) and its dead
frequency-domain path (processor.go:539-616, which applied a forward DFT
where an inverse belonged) with the textbook O(N log N) scheme:

- complex signals are **planar** (re, im) float32 pairs (ops/cplx.py) and
  every transform is the DFT-matmul FFT (ops/fft.py);
- signals for all stations are FFT'd **once per segment** and every station
  pair reuses them (cross-spectra are outer products on the pair axis);
- long captures stream through fixed-size segments under ``lax.scan``,
  coherently accumulating the cross-power spectrum on device — this is the
  "coherent integration" the reference approximates blockwise
  (processor.go:682-726) done exactly, with O(seg) memory;
- GCC weighting (PHAT / SCOT / Hannan-Thomson ML / none) applies to the
  *accumulated* spectrum, one inverse FFT per pair yields the correlation,
  and the peak is refined to sub-sample precision by a parabolic fit plus
  phase-slope regression (with a carrier-phase intercept).

Sign convention: for pair ``(i, j)`` the cross-spectrum is
``X_j · conj(X_i)``, so a **positive** delay means the signal arrives at
station *j* later than at station *i* — matching the solver's convention
(solve/multilateration.py).

Correctness window: with FFT length ≥ seg_len + max_lag the circular
correlation equals the linear one for all |lag| ≤ max_lag (zero-padding
argument), so the ±max_lag window carries no wraparound alias.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from tdoa_tpu.ops import fft as mfft
from tdoa_tpu.ops.cplx import C, from_complex
from tdoa_tpu.ops.peaks import parabolic_peak, peak_quality
from tdoa_tpu.utils.constants import DEFAULT_MAX_LAG


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def correlation_lags(max_lag: int) -> np.ndarray:
    """Lag axis for the correlation window: [-max_lag, ..., +max_lag]."""
    return np.arange(-max_lag, max_lag + 1)


class CorrResult(NamedTuple):
    delay: jax.Array  # [m] sub-sample delay estimate (samples)
    peak_value: jax.Array  # [m] normalized peak magnitude
    quality: jax.Array  # [m] peak-to-sidelobe ratio
    corr: jax.Array  # [m, 2*max_lag+1] normalized |correlation| window
    delay_std: jax.Array  # [m] 1σ delay standard error (samples); 0 when
    #                         the phase-slope refinement didn't run
    # The COMPLEX correlation window (same normalization as ``corr`` =
    # its magnitude): multipath decomposition needs the components'
    # relative carrier phases — echoes add coherently, and magnitude
    # alone cannot separate constructive from destructive overlap
    # (dsp/multipath.py).
    corr_re: jax.Array = None
    corr_im: jax.Array = None


@jax.named_scope("segment_fft_accumulate")
def _accumulate_cross_spectra(
    x: C,
    pair_idx,
    seg_len: int,
    fft_len: int,
    fft_precision: str = "f32",
    seg_batch: int = 1,
):
    """Scan segments, accumulating per-pair cross-spectra and per-station
    spectral power. Returns (cross C[m, F], psd [n_st, F], energy [n_st]).

    ``seg_batch`` segments FFT together per scan step and reduce before
    touching the accumulators (default 1).

    The name scope lets profiler traces attribute this stage's device
    time to it.
    """
    n_st, n = x.re.shape
    n_seg = n // seg_len
    while seg_batch > 1 and n_seg % seg_batch:
        seg_batch -= 1
    n_steps = n_seg // seg_batch

    def seg_fft(s):
        """FFT a batch of segments: [n_st, B, F]."""
        sl = lambda a: jax.lax.dynamic_slice(
            a, (0, s * seg_batch * seg_len), (n_st, seg_batch * seg_len)
        ).reshape(n_st, seg_batch, seg_len)
        return mfft.fft(C(sl(x.re), sl(x.im)), fft_len, fft_precision)

    def step(carry, s):
        (cr, ci, psd) = carry
        xf = seg_fft(s)  # C [n_st, B, F]
        xj = C(xf.re[pair_idx[:, 1]], xf.im[pair_idx[:, 1]])
        xi = C(xf.re[pair_idx[:, 0]], xf.im[pair_idx[:, 0]])
        cross = xj.mul_conj(xi)  # [m, B, F]
        return (
            cr + jnp.sum(cross.re, axis=1),
            ci + jnp.sum(cross.im, axis=1),
            psd + jnp.sum(xf.abs2(), axis=1),
        ), None

    m = pair_idx.shape[0]
    # Adding 0·x[0,0] ties the accumulators' mesh-varying type (vma) to the
    # input's, so the scan carry typechecks identically under shard_map
    # (parallel/mesh.py) and in the single-chip path.
    vma0 = 0.0 * x.re[0, 0]
    init = (
        jnp.zeros((m, fft_len), jnp.float32) + vma0,
        jnp.zeros((m, fft_len), jnp.float32) + vma0,
        jnp.zeros((n_st, fft_len), jnp.float32) + vma0,
    )
    if n_steps == 1:
        (cr, ci, psd), _ = step(init, 0)
    else:
        (cr, ci, psd), _ = jax.lax.scan(step, init, jnp.arange(n_steps))
    energy = jnp.sum(x.abs2()[:, : n_seg * seg_len], axis=-1)
    return C(cr, ci), psd, energy


def _weight_factor(
    cross: C, psd, pair_idx, weighting: str, eps: float, n_seg=None
):
    """The real per-bin GCC weighting multiplier s [m, F] such that the
    weighted spectrum is ``cross ⊙ s`` (1 for weighting="none")."""
    mag = cross.abs()
    if weighting == "none":
        return jnp.ones_like(mag)
    if weighting == "phat":
        return 1.0 / (
            mag + eps * jnp.mean(mag, axis=-1, keepdims=True) + 1e-30
        )
    if weighting == "scot":
        denom = jnp.sqrt(
            jnp.maximum(psd[pair_idx[:, 0]] * psd[pair_idx[:, 1]], 0.0)
        )
        return 1.0 / (
            denom + eps * jnp.mean(denom, axis=-1, keepdims=True) + 1e-30
        )
    if weighting in ("ht", "ml"):
        # Hannan–Thomson (maximum-likelihood) GCC: PHAT phase times an
        # SNR weight |γ|²/(1−|γ|²) from the segment-averaged magnitude-
        # squared coherence. Noise-only bins (γ²≈1/S over S segments) are
        # crushed instead of voting with unit weight like plain PHAT — the
        # decisive difference for narrowband signals in wideband noise.
        # With a single segment γ ≡ 1 and the clamp reduces this to a
        # scaled PHAT.
        # Clamp at zero defensively: an accumulator that rounds a bin's
        # power slightly negative would NaN the sqrt and poison every lag.
        saa = jnp.maximum(psd[pair_idx[:, 0]], 0.0)
        sbb = jnp.maximum(psd[pair_idx[:, 1]], 0.0)
        # sqrt-form avoids overflowing the 4th-power product for large
        # spectral magnitudes.
        denom = jnp.sqrt(saa) * jnp.sqrt(sbb)
        gamma = mag / jnp.maximum(denom, 1e-30)
        gamma2 = jnp.clip(gamma * gamma, 0.0, 0.98)
        if n_seg is not None:
            # Debias the segment-averaged coherence: for INCOHERENT
            # bins E[γ̂²] = 1/S over S segments, so with few segments
            # raw γ̂² hands noise-only bins real weight (at S=2, noise
            # bins average γ̂²≈0.5 and some draw near 1, letting their
            # random phases outvote a narrowband signal's few honest
            # bins — measured 3-to-50-sample delay errors on short
            # captures). The standard Welch debias maps the noise
            # expectation to zero. S=1 carries no coherence
            # information at all; keep the raw clamp (≈ scaled PHAT)
            # rather than zeroing every weight.
            s = jnp.asarray(n_seg, jnp.float32)
            bias = jnp.where(s > 1.0, 1.0 / jnp.maximum(s, 1.0), 0.0)
            gamma2 = jnp.clip(
                (gamma2 - bias) / jnp.maximum(1.0 - bias, 1e-6),
                0.0, 0.98,
            )
        snr_w = gamma2 / (1.0 - gamma2)
        # A bin with (near-)zero power carries no information: a tiny
        # denominator makes gamma explode and would hand the garbage bin
        # the MAXIMUM weight. Zero it instead.
        floor = 1e-9 * jnp.mean(denom, axis=-1, keepdims=True)
        snr_w = jnp.where(denom > floor, snr_w, 0.0)
        d = mag + eps * jnp.mean(mag, axis=-1, keepdims=True) + 1e-30
        w = snr_w / jnp.maximum(jnp.max(snr_w, axis=-1, keepdims=True), 1e-30)
        return w / d
    raise ValueError(f"unknown GCC weighting: {weighting!r}")


def _weight_spectrum(
    cross: C, psd, pair_idx, weighting: str, eps: float, n_seg=None
) -> C:
    if weighting == "none":
        return cross
    s = _weight_factor(cross, psd, pair_idx, weighting, eps, n_seg)
    return C(cross.re * s, cross.im * s)


def _lag_window(r: jax.Array, max_lag: int) -> jax.Array:
    """Reorder the circular correlation to lags [-max_lag, ..., +max_lag]."""
    if max_lag == 0:
        # r[..., -0:] would select the WHOLE array, not zero elements.
        return r[..., :1]
    return jnp.concatenate([r[..., -max_lag:], r[..., : max_lag + 1]], axis=-1)


def _phase_slope_refine(cross: C, coarse_delay, fft_len: int,
                        max_lag: int = 0, peak_phase=None,
                        clip_samples: float = 1.0):
    """Refine a coarse delay by weighted LS on the cross-spectrum phase.

    For pair spectrum ``C = X_j·conj(X_i)`` a pure delay d gives
    ``C_k ∝ exp(−j2π f_k d)``. Deramp by the coarse estimate, then fit the
    residual phase as φ ≈ θ − 2π f δ with bins weighted by |C|² — the
    intercept θ absorbs the constant carrier phase offset between the two
    receivers, and the slope recovers δ to well under 0.01 sample at
    useful SNR (docs/audio-pattern-matching.md:128-131 wanted this,
    unbuilt).
    """
    f = jnp.asarray(mfft.fftfreq(fft_len))  # cycles/sample
    # Weights relative to each row's largest: the fit is invariant to
    # their scale, and raw |C|² of a long accumulation (|C| ~ seg·S
    # after unit-RMS prescaling, ~7e7 at 100 s) makes the normal-
    # equation products Σw·Σwf² overflow float32 to inf − inf = NaN.
    w = cross.abs2()
    w = w / jnp.maximum(jnp.max(w, axis=-1, keepdims=True), 1e-30)
    # Deramp in angle space: angle(C·e^{+j2πfd}) == wrap(angle(C) + 2πfd)
    # exactly, and the wrap is one round+fma instead of a sin/cos pair
    # and a complex multiply per bin.
    two_pi = jnp.float32(2.0 * jnp.pi)
    if 0 < max_lag and fft_len * (max_lag + 1) < 2**31:
        # The coarse delay is an integer, so f·d mod 1 = (k·d mod F)/F is
        # exact in int32 — an f32 product 2πf·d would carry ~1e-3-cycle
        # rounding error at |d|~2e4 (the sin/cos path had the same flaw).
        k = jnp.arange(fft_len, dtype=jnp.int32)
        d_i = jnp.round(coarse_delay).astype(jnp.int32)
        frac = (k[None, :] * d_i[:, None]) % fft_len
        ramp = frac.astype(jnp.float32) * jnp.float32(2.0 * np.pi / fft_len)
    else:
        ramp = two_pi * f[None, :] * coarse_delay[:, None]
    # Re-center by the carrier-phase intercept BEFORE wrapping: with the
    # receivers' constant phase offset θ near ±π, the wrapped in-band
    # phases split into +π/−π clusters and the weighted LS slope blows
    # up (observed: δ=+2.5 for a true −0.6, then clipped — a 1.6-sample
    # bias). θ is the complex correlation's phase at the peak lag
    # (callers pass it for free); the fit's own intercept absorbs any
    # estimation error in θ̂.
    if peak_phase is None:
        # Non-hot paths (e.g. CAF): weighted mean phasor of the
        # derampled spectrum, wrap-free by construction.
        from tdoa_tpu.ops.cplx import exp_i

        de = exp_i(ramp)
        c = cross * de
        theta = jnp.arctan2(
            jnp.sum(w * c.im, axis=-1), jnp.sum(w * c.re, axis=-1)
        )
    else:
        theta = peak_phase
    raw = cross.angle() + ramp - theta[:, None]
    phi = raw - two_pi * jnp.round(raw / two_pi)
    sw = jnp.sum(w, axis=-1)
    swf = jnp.sum(w * f[None, :], axis=-1)
    swff = jnp.sum(w * f[None, :] ** 2, axis=-1)
    swp = jnp.sum(w * phi, axis=-1)
    swfp = jnp.sum(w * f[None, :] * phi, axis=-1)
    det = sw * swff - swf * swf
    slope = (sw * swfp - swf * swp) / jnp.maximum(det, 1e-30)
    intercept = (swff * swp - swf * swfp) / jnp.maximum(det, 1e-30)
    delta = -slope / (2.0 * jnp.pi)
    # Guard: clip the correction at ±1 sample of the coarse peak. A
    # wider, bandwidth-adaptive bound was tried (the phase slope is
    # unambiguous much further out for narrowband signals) and REJECTED:
    # under multipath the aggregate cross-spectrum's slope is the
    # energy-weighted mean of direct and echo delays, and a loose bound
    # lets the refine drift off the direct-path peak the correlation
    # argmax correctly selected.
    delta = jnp.clip(delta, -clip_samples, clip_samples)

    # Standard error of the slope, scale-invariant in the (relative)
    # weights: var(slope) ≈ σ_r² / (n_eff · S_f) with
    #   σ_r² = Σw·r²/Σw     (weighted residual phase variance),
    #   S_f  = Σw(f−f̄)²/Σw  (weighted spread of frequency),
    #   n_eff = (Σw)²/Σw²   (effective number of independent bins).
    # For uniform weights this is the classic OLS slope variance; /2π
    # converts to samples — the error bar the solver covariance consumes.
    resid = phi - (intercept[:, None] - 2.0 * jnp.pi * f[None, :]
                   * delta[:, None])
    sw_safe = jnp.maximum(sw, 1e-30)
    sigma_r2 = jnp.sum(w * resid * resid, axis=-1) / sw_safe
    s_f = jnp.maximum(swff / sw_safe - (swf / sw_safe) ** 2, 1e-30)
    n_eff = sw_safe**2 / jnp.maximum(jnp.sum(w * w, axis=-1), 1e-30)
    delay_std = jnp.sqrt(sigma_r2 / (n_eff * s_f)) / (2.0 * jnp.pi)
    # RMS width of the correlation peak envelope in samples (inverse of
    # the weighted spectral spread) — the length scale of coarse-argmax
    # jitter the slope fit cannot see.
    peak_width = 1.0 / (2.0 * jnp.pi * jnp.sqrt(s_f))
    return coarse_delay + delta, delay_std, peak_width


def _finish_correlation(
    cross: C,
    psd,
    energy,
    pair_idx,
    max_lag: int,
    weighting: str,
    eps: float,
    fft_len: int,
    refine: str,
    n_seg=None,
) -> CorrResult:
    """Accumulated cross-spectra → weighted correlation → refined peaks.

    Split out so the multi-chip path (parallel/mesh.py) can psum the
    accumulators over the mesh and run this replicated tail unchanged.
    ``n_seg`` (static int or traced scalar) is the number of averaged
    segments behind the accumulators — it debiases the coherence the
    HT/ML weights use.
    """
    weighted = _weight_spectrum(cross, psd, pair_idx, weighting, eps, n_seg)
    r = mfft.ifft(weighted)  # C [m, F]
    wr = _lag_window(r.re, max_lag)
    wi = _lag_window(r.im, max_lag)
    win = jnp.sqrt(wr * wr + wi * wi)

    if weighting == "none":
        # Normalize to a correlation coefficient: perfect self-match → 1
        # (ifft(A·conj(A))[0] = Σ|a|² by Parseval, so divide by √(E_a·E_b)).
        norm = jnp.maximum(
            jnp.sqrt(energy[pair_idx[:, 0]] * energy[pair_idx[:, 1]]),
            1e-30,
        )[:, None]
        win = win / norm
        wr = wr / norm
        wi = wi / norm
    # PHAT-family spectra are unit-magnitude, so ifft peaks are already ≤ 1
    # with equality at perfect coherence.

    pos, val = parabolic_peak(win)
    delay = pos - jnp.float32(max_lag)
    if refine == "phase":
        coarse = jnp.round(delay)
        # Carrier-phase intercept = the complex correlation's phase at
        # the peak lag — already computed in the windowed ifft (read
        # with a one-hot reduction over the window).
        pos_i = jnp.round(pos).astype(jnp.int32)
        onehot = jnp.arange(win.shape[-1])[None, :] == pos_i[:, None]
        pr = jnp.sum(jnp.where(onehot, wr, 0.0), axis=-1)
        pi = jnp.sum(jnp.where(onehot, wi, 0.0), axis=-1)
        peak_phase = jnp.arctan2(pi, pr)
        delay, delay_std, peak_width = _phase_slope_refine(
            cross, coarse, fft_len, max_lag, peak_phase
        )
    else:
        delay_std = jnp.zeros_like(delay)
        peak_width = None
    quality = peak_quality(win)
    if peak_width is not None:
        # Coarse-peak location error. The argmax of a correlation peak
        # of rms width W samples, perturbed by correlation-domain noise
        # 1/q of the peak (q = peak-to-sidelobe amplitude ratio),
        # jitters by ~W/q — band-limited noise displaces a smooth peak
        # by (noise slope)/(peak curvature) ≈ (σ_n/W)/(p/W²) = W·σ_n/p.
        # The phase-slope σ above models only the sub-sample fit; its
        # ±1-sample deramp window also CORRECTS coarse jitter up to one
        # sample, so only the excess beyond 1 sample survives (relu in
        # quadrature). Narrowband weak signals — wide peak, modest q —
        # are exactly where the slope σ alone proved 10-70x optimistic
        # (scripts/ellipse_calibration.py); wideband strong signals are
        # unaffected. Beyond the search window the estimate is
        # uniform-random: cap at the window's uniform std.
        sigma_coarse = peak_width / jnp.maximum(quality, 1.0)
        excess2 = jnp.maximum(sigma_coarse * sigma_coarse - 1.0, 0.0)
        cap = (2.0 * max_lag + 1.0) / jnp.sqrt(12.0)
        delay_std = jnp.minimum(
            jnp.sqrt(delay_std * delay_std + excess2), cap
        )
    return CorrResult(
        delay=delay, peak_value=val, quality=quality, corr=win,
        delay_std=delay_std, corr_re=wr, corr_im=wi,
    )


def _zoom_corr_delay(
    wspec: C, coarse, fft_len: int, max_lag: int, half_width: int = 16
) -> jax.Array:
    """Peak delay of a weighted cross-spectrum, evaluated only on a
    ±half_width lag window around ``coarse`` (per row) — a zoom DFT.

    Four [m,F]×[F,2K+1] matmuls instead of a full iFFT: the split-half
    σ probe needs each half's peak near the full estimate, not the
    whole correlation function. The per-row deramp uses the exact
    int32 fraction trick (see _phase_slope_refine): a float32 product
    2πf·d carries ~1e-3-cycle error at |d|~2e4. Same overflow guard as
    there: k·d reaches fft_len·max_lag, so past 2³¹ fall back to the
    float ramp rather than silently wrapping int32.
    """
    if 0 < max_lag and fft_len * (max_lag + 1) < 2**31:
        k = jnp.arange(fft_len, dtype=jnp.int32)
        d_i = jnp.round(coarse).astype(jnp.int32)
        frac = (k[None, :] * d_i[:, None]) % fft_len
        ang = (2.0 * jnp.pi / fft_len) * frac.astype(jnp.float32)
    else:
        f_cyc = jnp.asarray(mfft.fftfreq(fft_len), jnp.float32)
        ang = jnp.float32(2.0 * jnp.pi) * f_cyc[None, :] * coarse[:, None]
    cr, sr = jnp.cos(ang), jnp.sin(ang)
    dre = wspec.re * cr - wspec.im * sr
    dim = wspec.re * sr + wspec.im * cr
    f = jnp.asarray(mfft.fftfreq(fft_len))  # cycles/sample
    delta = jnp.arange(
        -half_width, half_width + 1, dtype=jnp.float32
    )
    ang2 = (2.0 * jnp.pi) * f[:, None] * delta[None, :]
    er, ei = jnp.cos(ang2), jnp.sin(ang2)
    f32 = jnp.float32
    # HIGHEST: a float32 matmul may otherwise run in TF32 (10-bit
    # mantissa) on the GPU, too coarse for a sub-sample peak.
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    cre = (mm(dre, er) - mm(dim, ei)).astype(f32)
    cim = (mm(dre, ei) + mm(dim, er)).astype(f32)
    win = jnp.sqrt(cre * cre + cim * cim)
    pos, _ = parabolic_peak(win)
    return coarse + (pos - jnp.float32(half_width))


# Consistency factor for the K-group split σ, CALIBRATED AGAINST TRUTH
# (scripts/ellipse_calibration.py is the compliance test; the
# numbers come from a fixed-geometry noisy experiment).
# K=2: the MAD constant 1.4826 (a 2-draw std IS one absolute deviation
# whose median is 0.674σ); measured true/reported 1.05-1.27 after.
# K=4: the chi-median constant alone (1.126) left σ 2.1x small —
# the group probes share the full capture's coarse peak and weighting,
# so their spread misses a common-mode error component that the 2-group
# constant had absorbed numerically. 2.37 ≈ 1.126 · 2.1 makes the
# noisy-regime z = err/σ chi-distributed (measured p50/p97.5 of |z|:
# 1.41/4.83 → 0.67/2.30 against chi targets 0.674/2.24).
_SPLIT_STD_SCALE = {2: 1.4826, 4: 2.37}


def split_k(n_seg_total: int) -> int:
    """How many sub-accumulations the empirical error bar uses: 4-way
    when every group still holds ≥2 segments (a 3-dof σ has far lighter
    tails than the 1-dof half-split), 2-way down to 2 segments, else
    none. Static — shapes depend on it."""
    if n_seg_total >= 8:
        return 4
    if n_seg_total >= 2:
        return 2
    return 0


def _combine_splits(
    accs, pair_idx, max_lag, weighting, eps, fft_len, n_seg_total,
):
    """Full-capture CorrResult from K sub-capture accumulators, with the
    split empirical error bar folded into ``delay_std``.

    Each group's delay comes from a ±16-lag zoom DFT around the full
    estimate's coarse peak — running the full finish per group
    multiplied the iFFT cost K-fold, and cheap phase-slope probes
    collapse under phase wrap for
    multi-sample errors (every group fits the same shrunken slope and
    the σ reads zero). A group whose true peak lies outside the zoom
    window saturates at ±16 and still reports a correspondingly large
    σ. Each group's probe is weighted with the OTHER groups'
    (leave-one-out) debiased factor: a 1-2 segment group has no
    coherence of its own (HT degrades to PHAT and the probe peaks
    jitter ~0.5 sample even on clean signals, poisoning σ_emp) — but
    the FULL capture's factor must not be used either, because its
    1/(1−γ̂²) tail selects precisely the bins where EVERY segment's
    cross phasor aligned, including a corrupted group's noise. That
    selection bias dragged a half-wrecked capture's noise groups to
    the full estimate's delay (zoom delay 36.99 on pure noise,
    σ 0.003 where the honest answer is O(samples) — caught by the
    split-half check). LOO weights are independent of group
    k's noise, so a corrupted group's probe diverges and σ_emp
    inflates as designed; on clean captures the LOO factor selects
    the same coherent band and σ is unchanged.

    σ_emp = c_K · std(group delays)/√K — the standard error of their
    mean, median-unbiased by _SPLIT_STD_SCALE. The deterministic
    width/PSR model term stays on in the finish as a backstop: a K-draw
    σ can still land small by chance (the dominant failure at K=2,
    measured z p97.5 10.7 on 8-segment noisy captures), and its ReLU
    (only excess beyond the deramp's ±1-sample correction range
    survives) keeps clean signals untouched."""
    K = len(accs)
    cr_g = jnp.stack([a[0].re for a in accs])  # [K, m, F]
    ci_g = jnp.stack([a[0].im for a in accs])
    psd_g = jnp.stack([a[1] for a in accs])  # [K, n_st, F]
    cr = jnp.sum(cr_g, axis=0)
    ci = jnp.sum(ci_g, axis=0)
    psd = jnp.sum(psd_g, axis=0)
    energy = sum(a[2] for a in accs)
    res = _finish_correlation(
        C(cr, ci), psd, energy, pair_idx,
        max_lag, weighting, eps, fft_len, "phase",
        n_seg=n_seg_total,
    )
    coarse = jnp.round(res.delay)
    q, r = divmod(n_seg_total, K)
    m, n_st = pair_idx.shape[0], psd.shape[0]
    n_seg_loo_np = np.repeat(
        n_seg_total - (q + (np.arange(K) < r).astype(np.int64)), m
    ).astype(np.float32)

    with jax.named_scope("split_sigma_probe"):
        # All K probes in ONE batched pass: groups stack along the pair
        # axis ([K·m, F]) with per-group station offsets in the pair
        # list, so the LOO weighting and the zoom DFT each run as a
        # single op (K small matmuls → one). n_seg for the LOO debias is
        # per-row ([K·m, 1] broadcasts inside _weight_factor).
        loo_cross = C(
            (cr[None] - cr_g).reshape(K * m, -1),
            (ci[None] - ci_g).reshape(K * m, -1),
        )
        loo_psd = (psd[None] - psd_g).reshape(K * n_st, -1)
        pair_big = (
            jnp.tile(pair_idx, (K, 1))
            + (jnp.arange(K, dtype=pair_idx.dtype)
               .repeat(m)[:, None] * n_st)
        )
        n_seg_loo = jnp.asarray(n_seg_loo_np)[:, None]
        s_k = _weight_factor(
            loo_cross, loo_psd, pair_big, weighting, eps, n_seg_loo,
        )
        ds = _zoom_corr_delay(
            C(cr_g.reshape(K * m, -1) * s_k,
              ci_g.reshape(K * m, -1) * s_k),
            jnp.tile(coarse, K), fft_len, max_lag,
        ).reshape(K, m)
    var = jnp.sum((ds - jnp.mean(ds, axis=0)) ** 2, axis=0) / (K - 1)
    sigma_emp = jnp.float32(_SPLIT_STD_SCALE[K]) * jnp.sqrt(var / K)
    return res._replace(
        delay_std=jnp.maximum(res.delay_std, sigma_emp)
    )


def _split_half_sigma(
    cross_a: C, cross_b: C, wfac_a, wfac_b, coarse, fft_len: int,
    max_lag: int,
) -> jax.Array:
    """Empirical 1σ (samples) from two half-capture cross-spectra: each
    half's zoom-DFT peak near the full-capture coarse delay, half the
    disagreement, scaled to a consistent estimator. ``wfac_a`` weights
    half a's probe and must be computed WITHOUT half a (and vice
    versa): the halves must not self-weight (degenerate coherence),
    and the full capture's factor selection-biases a corrupted half's
    probe toward the full delay (see _combine_splits).

    Scale: with per-half delay noise σ_h, the full estimate (the
    halves' average) has σ_full = σ_h/√2 and (da−db) ~ N(0, 2σ_h²), so
    |da−db|/2 is distributed as σ_full·|N(0,1)| — a single absolute
    deviation whose MEDIAN is 0.674·σ_full. Left unscaled, the typical
    draw understates σ by 1.5x (measured: noisy-regime true/reported
    ratio 1.55-1.9, z p50 1.46 vs the 0.674 a calibrated σ gives).
    The MAD consistency constant 1.4826 = 1/Φ⁻¹(3/4) makes it
    median-unbiased — the same constant that makes a MAD a σ."""
    da = _zoom_corr_delay(
        C(cross_a.re * wfac_a, cross_a.im * wfac_a), coarse, fft_len,
        max_lag,
    )
    db = _zoom_corr_delay(
        C(cross_b.re * wfac_b, cross_b.im * wfac_b), coarse, fft_len,
        max_lag,
    )
    return jnp.float32(0.5 * 1.4826) * jnp.abs(da - db)


def _split_bounds(n_seg_total: int, K: int, unit: int) -> list:
    """Sample-index boundaries of the K split groups: K+1 cumulative
    offsets in units of ``unit`` (the segment length). When K does not
    divide n_seg_total the remainder is spread round-robin (group sizes
    q or q+1) — dumping it all into one group would give that group up
    to (2q-1)/q× the others' segment count, and the _SPLIT_STD_SCALE
    constants were calibrated on equal groups."""
    q, r = divmod(n_seg_total, K)
    bounds = [0]
    for k in range(K):
        bounds.append(bounds[-1] + (q + (1 if k < r else 0)) * unit)
    return bounds


def auto_seg_len(
    n: int,
    max_lag: int,
    seg_len: Optional[int],
    target_segs: int = 8,
    floor: int = 4096,
) -> Optional[int]:
    """Shrink a configured segment length so SHORT captures still hold
    ``target_segs`` Welch segments. More segments mean (a) a less-biased
    coherence estimate for the HT/ML weights — S=2 is the debias worst
    case and was measured costing ~1.9x in delay error std on noisy
    short captures — and (b) enough sub-accumulations for a multi-dof
    split σ (split_k). Long captures (n ≥ target·seg) keep the
    configured segment: their Welch average is already deep and the
    larger FFT amortizes better. Never shrinks below
    ``max_lag`` (resolve_seg's alias-free requirement) or ``floor``
    (frequency-resolution floor: a 4096-pt segment at 2 Msps still
    puts ~100 bins across a 50 kHz signal)."""
    if seg_len is None:
        return None
    while (n // seg_len < target_segs and seg_len // 2 > max_lag
           and seg_len // 2 >= floor):
        seg_len //= 2
    return seg_len


def resolve_seg(n: int, max_lag: int, seg_len: Optional[int], fft_len: Optional[int]):
    """Static segmentation parameters shared by single- and multi-chip paths.

    Anti-aliasing needs ``seg_len + max_lag ≤ fft_len``. Rather than
    doubling the FFT (the naive ``next_pow2(seg+lag)``, which doubles the
    dominant FLOP cost), keep the FFT at ``next_pow2(seg)`` and *shrink
    the segment* by max_lag — a ~1% increase in segment count instead of
    a 2× increase in transform work. A whole-signal correlation
    (seg_len=None / seg covers n) still pads up, since shrinking would
    drop samples.
    """
    whole = seg_len is None or seg_len >= n
    if whole:
        seg_len = n
        if fft_len is None:
            fft_len = next_pow2(seg_len + max_lag)
    elif fft_len is None:
        fft_len = next_pow2(seg_len)
        if seg_len + max_lag > fft_len:
            if max_lag < fft_len // 2:
                seg_len = fft_len - max_lag
            else:
                fft_len = next_pow2(seg_len + max_lag)
    if max_lag >= seg_len:
        raise ValueError(f"max_lag {max_lag} must be < seg_len {seg_len}")
    if seg_len + max_lag > fft_len:
        raise ValueError("fft_len too small for seg_len + max_lag")
    return seg_len, fft_len


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_lag", "seg_len", "weighting", "fft_len", "refine",
        "fft_precision", "seg_batch",
    ),
)
def correlate_pairs_planar(
    x: C,  # [n_st, N] planar complex
    pair_idx: jax.Array,  # [m, 2] int32
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "phat",
    eps: float = 1e-3,
    fft_len: Optional[int] = None,
    refine: str = "phase",  # "phase" | "parabolic"
    fft_precision: str = "f32",  # "f32" | "bf16" (ops/fft.py)
    seg_batch: int = 1,
) -> CorrResult:
    """All-pairs GCC cross-correlation on planar (re, im) signals.

    ``seg_len=None`` correlates the whole signal in one FFT; otherwise the
    capture streams through ``seg_len``-sample segments with on-device
    coherent accumulation (constant memory in capture length).
    """
    n = x.re.shape[1]
    seg_len, fft_len = resolve_seg(n, max_lag, seg_len, fft_len)
    # Per-station RMS pre-scaling: delay-invariant, and keeps the
    # accumulated |spectrum|² products (HT coherence uses 4th powers of
    # the input scale) inside float32 range for inputs of any unit —
    # e.g. FM audio in raw Hz.
    rms = jnp.sqrt(jnp.mean(x.abs2(), axis=-1, keepdims=True))
    inv = 1.0 / jnp.maximum(rms, 1e-30)
    x = C(x.re * inv, x.im * inv)
    n_seg_total = n // seg_len
    K = split_k(n_seg_total) if refine == "phase" else 0
    if K == 0:
        cross, psd, energy = _accumulate_cross_spectra(
            x, pair_idx, seg_len, fft_len, fft_precision, seg_batch
        )
        return _finish_correlation(
            cross, psd, energy, pair_idx, max_lag, weighting, eps, fft_len,
            refine, n_seg=n_seg_total,
        )
    # Split error bar: accumulate K contiguous slices of the capture
    # separately (same total work — the full accumulators are their
    # sum) and estimate each slice's delay too. The spread of the slice
    # delays is an EMPIRICAL 1σ that captures every
    # realization-dependent error source — coarse-peak displacement by
    # in-band noise, impairment residue, lobe hopping — which the
    # phase-slope model σ provably misses (ellipse-calibration study
    # measured it 10-70x optimistic on weak signals). The model σ stays
    # as the floor: a lucky agreement between slices must not claim
    # better precision than the spectrum supports. Systematic biases
    # common to all slices (e.g. static multipath) remain invisible to
    # both estimators.
    bounds = _split_bounds(n_seg_total, K, seg_len)
    accs = [
        _accumulate_cross_spectra(
            C(x.re[:, bounds[k]:bounds[k + 1]],
              x.im[:, bounds[k]:bounds[k + 1]]),
            pair_idx, seg_len, fft_len, fft_precision, seg_batch,
        )
        for k in range(K)
    ]
    return _combine_splits(
        accs, pair_idx, max_lag, weighting, eps, fft_len, n_seg_total,
    )


def correlate_pairs(
    x: Union[C, jax.Array],
    pair_idx: jax.Array,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "phat",
    eps: float = 1e-3,
    fft_len: Optional[int] = None,
    refine: str = "phase",
) -> CorrResult:
    """Convenience wrapper accepting complex/real arrays or planar
    pairs."""
    if not isinstance(x, C):
        x = from_complex(x)
    return correlate_pairs_planar(
        x, pair_idx, max_lag=max_lag, seg_len=seg_len, weighting=weighting,
        eps=eps, fft_len=fft_len, refine=refine,
    )


def correlate_two(
    a, b, max_lag: int = DEFAULT_MAX_LAG, **kwargs
) -> CorrResult:
    """Convenience: correlate one signal pair. Positive delay ⇒ ``b`` lags
    ``a``. Result fields have the pair axis squeezed."""
    if not isinstance(a, C):
        a = from_complex(a)
    if not isinstance(b, C):
        b = from_complex(b)
    x = C(jnp.stack([a.re, b.re]), jnp.stack([a.im, b.im]))
    res = correlate_pairs_planar(
        x, jnp.array([[0, 1]], jnp.int32), max_lag=max_lag, **kwargs
    )
    return CorrResult(*(v[0] for v in res))


def clock_correct_blocks(delays, stds, quality, peaks, corr_mag, corr_re,
                         corr_im, ref_geo_tdoa, clock_correction: bool = True):
    """Shared 3-block → clock-corrected-TDOA finalize tail.

    Every correlation front-end (the batch path, the shard_map mesh
    path, and the overlapped-ingest accumulator) produces the same per-block fields; this is the ONE
    copy of the algebra that turns them into ``process_blocks``'s
    result tuple, so the corrected-σ formula and the tuple layout can
    never diverge between paths.

    Inputs are per-block ``[3, m]`` arrays (block order REF₁, TGT,
    REF₂) plus the ``[3, m, W]`` correlation windows (magnitude and
    planar complex). REF blocks 1 and 3 bracket TGT; blocks are
    contiguous and equal length, so the TGT midpoint sits exactly
    between the REF midpoints — the per-pair clock offset there is the
    plain average of the two REF reads, with the known REF-transmitter
    propagation term (``ref_geo_tdoa``) removed (the correction
    processor.go:853-858 left unwired). The corrected-TDOA 1σ composes
    the TGT σ with the two REF estimates' variances at 1/4 each (they
    average). ``stds[1]`` (TGT-only σ) rides along so callers that
    re-measure the TGT block (the deramp path) can swap it out of the
    composite and keep the REF clock-correction variance.

    Returns ``(corrected, tgt_delay, ref_delays[m,2], clock,
    quality[3,m], peaks[3,m], corrected_std, tgt_window, tgt_std,
    win_c_blocks[2,3,m,W])``.
    """
    ref_delays = jnp.stack([delays[0], delays[2]], axis=-1)  # [m, 2]
    tgt_delay = delays[1]
    if clock_correction:
        ref_mid = 0.5 * (ref_delays[:, 0] + ref_delays[:, 1])
        clock = ref_mid - ref_geo_tdoa
        corrected = tgt_delay - clock
        corrected_std = jnp.sqrt(
            stds[1] ** 2 + 0.25 * (stds[0] ** 2 + stds[2] ** 2)
        )
    else:
        clock = jnp.zeros_like(tgt_delay)
        corrected = tgt_delay
        corrected_std = stds[1]
    win_c_blocks = jnp.stack([corr_re, corr_im])  # [2 (re/im), 3, m, W]
    return (corrected, tgt_delay, ref_delays, clock, quality, peaks,
            corrected_std, corr_mag[1], stds[1], win_c_blocks)
