"""Audio-pattern-matching TDOA: matched-filter each station against the
FM signal a KNOWN audio recording would generate.

This implements the reference's documented-but-never-built innovation
(docs/audio-pattern-matching.md): record the audio program a transmitter
is broadcasting, predict the RF pattern it generates
(``f_inst = f_carrier + k_f·audio``, audio-pattern-matching.md:41-47),
and search each station's capture for that pattern
(audio-pattern-matching.md:60-75). Where the standard pipeline
cross-correlates stations *pairwise* (both sides noisy), the matched
filter correlates each station against a NOISELESS template — per-pair
SNR improves ~3 dB, cost scales with stations N instead of pairs N²,
and each station gets an absolute time-of-arrival of the audio content.

Two matching domains:

- ``mode="audio"``: FM-demodulate the station blocks
  and correlate the audio. The template rides through the SAME
  demodulation chain (modulate → stack as an extra channel → demod all
  together), so every filter group delay is common and cancels.
  Receiver LO offsets become DC, removed at demod — no frequency
  search needed (the doc's "Doppler effects" challenge,
  audio-pattern-matching.md:117-119, dissolves). Deviation mismatch
  only scales audio amplitude, which correlation normalizes away.
- ``mode="rf"``: correlate the predicted complex-baseband RF pattern
  directly, searching a ±``lo_span_hz`` frequency window per station
  with the CAF machinery (the doc's "search with frequency offsets"
  solution). Coherent over the full bandwidth — sharper peaks when the
  deviation constant is known exactly — and it measures each
  station's LO offset as a by-product.
- ``mode="auto"`` (default): audio first; when the audio match fails
  its own validation — weak per-station peak-to-sidelobe or
  disagreement with the pairwise baseline — escalate to the rf-domain
  filter and keep whichever result cross-validates better. The audio
  domain collapses below the FM threshold (≲10 dB channel SNR: click
  noise replaces the program and the correlation peak wanders by
  hundreds of samples — measured on Monte Carlo seeds 31108/32208),
  exactly where the LINEAR rf-domain filter still works; conversely
  rf degrades when unsynchronized ms clocks force a clipped LO span.
  Auto gets both regimes right and names the escalation in a warning.

Per-station TOAs difference into pairwise TDOAs; the dual-REF clock
correction from the standard pipeline removes the station clock
offsets; the usual solver turns them into a fix. The standard pairwise
result rides along for cross-validation (the doc's validation ladder,
audio-pattern-matching.md:155-170).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from tdoa_tpu.ops.cplx import C, from_complex
from tdoa_tpu.utils.constants import DEFAULT_SAMPLE_RATE


class TemplateMatch(NamedTuple):
    """Per-station matched-filter result against one template."""

    toa_samples: jax.Array  # [n_st] IQ samples the station lags the template
    toa_std: jax.Array  # [n_st] 1σ, IQ samples
    quality: jax.Array  # [n_st] peak-to-sidelobe ratio
    peak_value: jax.Array  # [n_st] normalized correlation peak
    lo_offset_hz: Optional[jax.Array] = None  # [n_st] rf mode only
    # rf mode: the LO span actually searched (may be below the request
    # when max_lag forces a segment longer than the span allows).
    lo_span_eff_hz: Optional[float] = None


def template_iq(
    audio: np.ndarray,
    audio_fs: float,
    n_samples: int,
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    deviation_hz: float = 25_000.0,
) -> Tuple[C, float]:
    """Predict the complex-baseband FM pattern of an audio recording,
    on the capture clock, exactly ``n_samples`` long.

    Returns ``(template, covered_fraction)`` — the fraction of the
    capture window the recording spans. A shorter recording zero-pads
    (a burst template: the dead tail contributes nothing to the matched
    filter); a longer one truncates to the window.
    """
    from tdoa_tpu.dsp.filters import resample_fft
    from tdoa_tpu.dsp.fm import fm_modulate

    n_res = int(round(len(audio) * sample_rate / audio_fs))
    # Host-side prep, pinned to CPU: resample_fft is jnp.fft at audio
    # scale and runs once per recording. The planar f32 template transfers to the device
    # when the matched filter consumes it.
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        a = resample_fft(jnp.asarray(audio, jnp.float32), n_res)
        if n_res >= n_samples:
            a = a[:n_samples]
            covered = 1.0
        else:
            covered = n_res / n_samples
        tpl = fm_modulate(a, sample_rate, deviation_hz)
        if n_res < n_samples:
            pad = n_samples - n_res
            tpl = C(
                jnp.pad(tpl.re, (0, pad)),
                jnp.pad(tpl.im, (0, pad)),
            )
    return tpl, covered


@functools.partial(
    jax.jit,
    static_argnames=("sample_rate", "decim", "max_lag", "seg_len"),
)
def match_template_audio(
    tgt: C,  # [n_st, L] planar complex station blocks
    template: C,  # [L] planar complex predicted RF pattern
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    decim: int = 8,
    max_lag: int = 20000,
    seg_len: Optional[int] = None,
) -> TemplateMatch:
    """Audio-domain matched filter: demodulate stations AND template
    through one chain, correlate each station's audio against the
    template's. TOAs come back in IQ samples (sub-sample refined).
    """
    from tdoa_tpu.dsp.fm import fm_demodulate
    from tdoa_tpu.ops.corr import correlate_pairs_planar

    n_st = tgt.re.shape[0]
    xr = jnp.concatenate(
        [tgt.re, template.re[None]], axis=0).astype(jnp.float32)
    xi = jnp.concatenate(
        [tgt.im, template.im[None]], axis=0).astype(jnp.float32)
    xr = xr - jnp.mean(xr, axis=-1, keepdims=True)  # capture DC (u8 center)
    xi = xi - jnp.mean(xi, axis=-1, keepdims=True)

    audio = fm_demodulate(C(xr, xi), sample_rate, decim=decim)

    # Robust click limiter: near the FM threshold the discriminator
    # emits impulsive clicks whose amplitude dwarfs the program; they
    # dominate the correlation's energy and drag the peak by samples
    # (measured: a healthy-PSR match biased 5.6 IQ samples recovered to
    # 3.0 with the limiter; Monte Carlo seed 42008). Clamp each
    # channel's excursions at 4×(1.4826·MAD) ≈ 4σ of its own robust
    # scale — program audio is untouched (a Gaussian exceeds 4σ 0.006%
    # of the time, and the clean TEMPLATE channel rides through the
    # same clamp as a no-op), only clicks compress.
    med = jnp.median(audio, axis=-1, keepdims=True)
    mad = jnp.median(jnp.abs(audio - med), axis=-1, keepdims=True)
    lim = 4.0 * 1.4826 * jnp.maximum(mad, 1e-12)
    audio = med + jnp.clip(audio - med, -lim, lim)
    audio = audio - jnp.mean(audio, axis=-1, keepdims=True)

    # Pair (template, station): positive delay = station lags template
    # = the station's TOA of the audio content.
    pairs = jnp.stack(
        [jnp.full(n_st, n_st, jnp.int32),
         jnp.arange(n_st, dtype=jnp.int32)],
        axis=1,
    )
    max_lag_c = max(max_lag // decim + 2, 16)
    seg_c = (
        None if seg_len is None
        else max(seg_len // decim, 4 * max_lag_c)
    )
    # Plain (power-weighted) correlation, not GCC whitening: demodulated
    # audio occupies only the bottom of the decimated band, and
    # whitening hands the empty bins' common edge-leakage the vote (the
    # measured failure mode documented at process_blocks mode="fm").
    res = correlate_pairs_planar(
        C(audio, jnp.zeros_like(audio)), pairs,
        max_lag=max_lag_c, seg_len=seg_c, weighting="none",
    )
    s = jnp.float32(decim)
    return TemplateMatch(
        toa_samples=res.delay * s,
        toa_std=res.delay_std * s,
        quality=res.quality,
        peak_value=res.peak_value,
    )


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def match_template_rf(
    tgt: C,  # [n_st, L]
    template: C,  # [L]
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    max_lag: int = 20000,
    lo_span_hz: float = 200.0,
    n_doppler: int = 64,
    seg_len: Optional[int] = None,
) -> TemplateMatch:
    """RF-domain matched filter with per-station LO-offset search.

    A receiver LO error of Δf rotates the station against the template
    by 2πΔf·t — fatal to a coherent matched filter over seconds — so
    the match runs on the CAF surface over ±``lo_span_hz``
    (audio-pattern-matching.md:117-119's "search with frequency
    offsets"). The winning Doppler bin IS the station's LO offset
    (sub-bin refined), reported per station.
    """
    from tdoa_tpu.ops.caf import caf_pairs

    n_st = tgt.re.shape[0]
    xr = jnp.concatenate(
        [tgt.re, template.re[None]], axis=0).astype(jnp.float32)
    xi = jnp.concatenate(
        [tgt.im, template.im[None]], axis=0).astype(jnp.float32)
    xr = xr - jnp.mean(xr, axis=-1, keepdims=True)
    xi = xi - jnp.mean(xi, axis=-1, keepdims=True)

    if seg_len is None:
        # Slow-time Doppler steering is unambiguous over ±fs/(2·seg):
        # size the segment so the search span fits, within [2^10, 2^15]
        # — but the CAF also needs seg_len > max_lag (the lag window
        # must fit one segment), and the lag requirement wins: raw
        # TOAs include the stations' clock offsets (up to ms ⇒
        # max_lag 20000 by default), while an LO span clipped below
        # the request degrades gracefully (the caller warns; aliasing
        # beyond the span only costs coherence, the lag peak stays).
        min_seg = 1 << 10
        while min_seg <= max_lag:
            min_seg <<= 1
        seg_len = max(
            min_seg,
            min(1 << 15,
                max(1 << 10,
                    _pow2_at_most(int(sample_rate / (2.0 * lo_span_hz))))),
        )
    span_eff = min(lo_span_hz, sample_rate / (2.0 * seg_len))
    pairs = jnp.stack(
        [jnp.full(n_st, n_st, jnp.int32),
         jnp.arange(n_st, dtype=jnp.int32)],
        axis=1,
    )
    # weighting="none": the template side is noiseless, so the plain
    # cross-power IS the optimal matched filter; PHAT whitening instead
    # hands the empty out-of-band bins' common segment-edge leakage the
    # vote and buries near-zero TOAs under the lag-0 artifact.
    res = caf_pairs(
        C(xr, xi), pairs, sample_rate=sample_rate,
        max_lag=max_lag, seg_len=seg_len, n_doppler=n_doppler,
        doppler_span_hz=span_eff, weighting="none",
    )
    # Peak-to-sidelobe quality on the winning Doppler row, peak
    # neighborhood excluded — same PSR convention as the GCC path.
    surf = res.surface  # [n_st, D, W]
    row_peak = jnp.max(surf, axis=-1)  # [n_st, D]
    di = jnp.argmax(row_peak, axis=-1)  # [n_st]
    row = jnp.take_along_axis(
        surf, di[:, None, None].repeat(surf.shape[-1], -1), axis=1
    )[:, 0, :]  # [n_st, W]
    w = row.shape[-1]
    k = jnp.argmax(row, axis=-1)
    lag_idx = jnp.arange(w)[None, :]
    guard = jnp.abs(lag_idx - k[:, None]) > 8
    side = jnp.where(guard, row, 0.0)
    rms_side = jnp.sqrt(
        jnp.sum(side**2, axis=-1) / jnp.maximum(jnp.sum(guard, -1), 1)
    )
    peak = jnp.max(row, axis=-1)
    quality = peak / jnp.maximum(rms_side, 1e-30)
    # Delay-σ proxy from the peak's parabolic curvature is not exposed
    # by caf_pairs; use the Doppler-compensated phase-slope σ stand-in:
    # σ ≈ lag-bin / PSR (empirically conservative on the CAF surface).
    toa_std = 1.0 / jnp.maximum(quality, 1.0)
    return TemplateMatch(
        toa_samples=res.delay,
        toa_std=toa_std,
        quality=quality,
        peak_value=peak,
        lo_offset_hz=res.doppler_hz,
        lo_span_eff_hz=float(span_eff),
    )


@dataclasses.dataclass
class AudioMatchResult:
    """Template-matched TDOA result, with the standard pairwise result
    riding along for cross-validation."""

    station_names: List[str]
    pair_idx: np.ndarray  # [m, 2]
    toa_samples: np.ndarray  # [n] per-station template TOA, IQ samples
    toa_std_samples: np.ndarray  # [n]
    station_quality: np.ndarray  # [n] matched-filter PSR
    template_tdoa_samples: np.ndarray  # [m] raw TOA differences
    corrected_tdoa_samples: np.ndarray  # [m] after dual-REF clock removal
    tdoa_seconds: np.ndarray  # [m]
    tdoa_std_s: np.ndarray  # [m]
    fix: "FixResult"  # noqa: F821 — solve.multilateration.FixResult
    pairwise: "TDOAResult"  # noqa: F821 — the standard pipeline's result
    covered_fraction: float  # of the TGT window the recording spans
    lo_offset_hz: Optional[np.ndarray] = None  # [n] rf mode
    warnings: List[str] = dataclasses.field(default_factory=list)
    # The matching domain that produced this result ("audio"/"rf") —
    # informative under mode="auto", which may escalate.
    mode_used: str = "audio"


def cross_validation_warnings(
    corrected: np.ndarray,  # [m] template clock-corrected TDOAs, samples
    sigma: np.ndarray,  # [m] template per-pair 1σ, samples
    pairwise,  # TDOAResult — the standard pipeline's result
    fix,  # FixResult from the template TDOAs
    names: Sequence[str],
    pairs: np.ndarray,
    fs: float,
) -> List[str]:
    """Template-vs-pairwise cross-validation (the doc's validation
    ladder): disagreement is a warning, not an error — the operator
    decides which measurement to trust. Two rungs:

    1. Per-pair: |pairwise − template| against the COMBINED σ
       (template ⊕ pairwise). Gating on the template σ alone at a
       slack multiple let a 3.6σ disagreement — a 12-sample template
       error and a 2 km bad fix — pass silently (Monte Carlo seed
       21908). Floor 3.0 samples keeps clean captures quiet
       (agreement there is sub-sample).
    2. Fix separation: the two fixes must agree within 3σ of their
       combined error ellipses. Per-pair tails can each sit just under
       rung 1 while their joint effect moves the fix kilometers; the
       separation catches that accumulation directly. Floor 50 m.
    """
    return _cross_validation(
        corrected, sigma, pairwise, fix, names, pairs, fs
    )[0]


def _cross_validation(
    corrected: np.ndarray,
    sigma: np.ndarray,
    pairwise,
    fix,
    names: Sequence[str],
    pairs: np.ndarray,
    fs: float,
) -> Tuple[List[str], Tuple[float, int]]:
    """Cross-validation warnings plus a comparable badness score
    ``(worst_normalized_disagreement, rungs_fired)`` — mode="auto"
    ranks the audio- and rf-domain candidates by it (smaller wins,
    lexicographic). The continuous magnitude leads: a candidate whose
    worst pair sits 60x over the gate must lose to one 1.2x over it
    even if the latter trips a rung on more pairs."""
    out: List[str] = []
    pw = np.asarray(pairwise.corrected_tdoa_samples, np.float64)
    pw_sig = (
        np.asarray(pairwise.tdoa_std_s, np.float64) * fs
        if pairwise.tdoa_std_s is not None
        else np.zeros_like(pw)
    )
    disagree = np.abs(pw - corrected)
    comb = np.sqrt(np.asarray(sigma, np.float64) ** 2 + pw_sig**2)
    # Badness normalizes by a scale COMMON to every candidate — the
    # pairwise baseline's σ with the absolute floor, NOT the combined σ
    # the warning gate uses. Normalizing by each candidate's own σ
    # would let a sloppy candidate shrink its own score: the audio
    # domain's inflated σs under FM-threshold noise out-scored the
    # accurate rf match exactly when escalation mattered (seed 31308).
    worst_norm = float(
        np.max(disagree / np.maximum(3.0, 3.5 * pw_sig), initial=0.0)
    )
    bad = disagree > np.maximum(3.0, 3.5 * comb)
    if bad.any():
        worst = int(np.argmax(disagree / np.maximum(comb, 1e-9)))
        i, j = pairs[worst]
        out.append(
            f"template and pairwise TDOAs disagree on {int(bad.sum())} "
            f"pair(s); worst {names[i]}-{names[j]}: "
            f"{disagree[worst]:.2f} samples "
            f"({disagree[worst] / max(comb[worst], 1e-9):.1f}σ combined)"
        )

    if (
        fix.ellipse is not None
        and pairwise.fix.ellipse is not None
        and np.isfinite([fix.lat, fix.lon,
                         pairwise.fix.lat, pairwise.fix.lon]).all()
    ):
        from tdoa_tpu.geo import lla_to_enu

        sep = float(np.linalg.norm(lla_to_enu(
            np.array([fix.lat, fix.lon, pairwise.fix.elev]),
            np.array([pairwise.fix.lat, pairwise.fix.lon,
                      pairwise.fix.elev]),
        )[:2]))
        allow = 3.0 * (fix.ellipse[0] + pairwise.fix.ellipse[0])
        # Score side: pairwise-only scale (common across candidates).
        worst_norm = max(
            worst_norm,
            sep / max(3.0 * pairwise.fix.ellipse[0], 50.0),
        )
        if sep > max(allow, 50.0):
            out.append(
                f"template fix and pairwise fix are {sep:.0f} m apart "
                f"(vs {allow:.0f} m at 3σ of the combined ellipses) — "
                "one of the two measurements is biased; compare "
                "per-pair TDOAs and the match quality before trusting "
                "either"
            )
    return out, (worst_norm, len(out))


def match_captures(
    processor,  # TDOAProcessor
    captures: Dict[str, Tuple],
    audio: np.ndarray,
    audio_fs: float,
    mode: str = "auto",
    deviation_hz: float = 25_000.0,
    decim: int = 8,
    lo_span_hz: float = 200.0,
    n_doppler: int = 64,
) -> AudioMatchResult:
    """Full audio-pattern-matching run on in-memory captures.

    1. the standard pairwise pipeline runs first — its dual-REF clock
       offsets calibrate the template TOAs, and its fix is the
       cross-validation baseline;
    2. the recording becomes a predicted RF template on the capture
       clock (:func:`template_iq`);
    3. each station's TGT block is matched against the template
       (``mode="audio"``, ``"rf"``, or ``"auto"`` — audio with
       validation-driven escalation to rf);
    4. TOA differences − clock offsets → corrected TDOAs → fix.
    """
    from tdoa_tpu.solve.multilateration import solve_fix

    if mode not in ("audio", "rf", "auto"):
        raise ValueError(
            f"mode must be 'audio', 'rf' or 'auto', got {mode!r}"
        )
    cfg = processor.config
    pairwise = processor.process_captures(captures)
    names = pairwise.station_names
    pairs = pairwise.pair_idx

    def prep(b) -> C:
        if not isinstance(b, C):
            b = from_complex(b)
        b = C(b.re.astype(jnp.float32), b.im.astype(jnp.float32))
        if cfg.truncate_samples is not None:
            b = C(b.re[: cfg.truncate_samples], b.im[: cfg.truncate_samples])
        return b

    blocks = [prep(captures[n][1]) for n in names]
    tgt = C(
        jnp.stack([b.re for b in blocks]),
        jnp.stack([b.im for b in blocks]),
    )
    L = int(tgt.re.shape[-1])
    tpl, covered = template_iq(
        audio, audio_fs, L,
        sample_rate=cfg.sample_rate, deviation_hz=deviation_hz,
    )

    base_warnings: List[str] = []
    if covered < 0.5:
        base_warnings.append(
            f"audio recording spans only {covered:.0%} of the target "
            "window — matched-filter SNR is reduced accordingly"
        )
    fs = cfg.sample_rate
    lla = processor.stations.lla_array(names)

    def run_domain(domain: str) -> Tuple[TemplateMatch, List[str]]:
        if domain == "audio":
            return match_template_audio(
                tgt, tpl, sample_rate=fs, decim=decim,
                max_lag=cfg.max_lag, seg_len=cfg.seg_len,
            ), []
        m = match_template_rf(
            tgt, tpl, sample_rate=fs, max_lag=cfg.max_lag,
            lo_span_hz=lo_span_hz, n_doppler=n_doppler,
        )
        extra: List[str] = []
        if (m.lo_span_eff_hz is not None
                and m.lo_span_eff_hz < 0.99 * lo_span_hz):
            extra.append(
                f"rf-mode LO search span clipped to "
                f"±{m.lo_span_eff_hz:.1f} Hz (requested "
                f"±{lo_span_hz:.1f}): max_lag {cfg.max_lag} forces a "
                f"segment longer than the span allows — an LO offset "
                f"beyond the clipped span aliases (costing coherence); "
                f"lower --max-lag if clocks permit, or use "
                f"--match-mode audio (LO-immune)"
            )
        return m, extra

    def assemble(
        domain: str, m: TemplateMatch, extra: List[str]
    ) -> Tuple[AudioMatchResult, Tuple[float, int], bool]:
        toa = np.asarray(m.toa_samples, np.float64)
        toa_std = np.asarray(m.toa_std, np.float64)
        q = np.asarray(m.quality, np.float64)
        warnings = list(base_warnings) + list(extra)

        low_q = [names[i] for i in range(len(names)) if q[i] < 3.0]
        if low_q:
            warnings.append(
                "weak template match (peak-to-sidelobe < 3) at: "
                + ", ".join(low_q)
                + " — check the recording covers the capture window and "
                "the station actually received the target"
            )

        raw = toa[pairs[:, 1]] - toa[pairs[:, 0]]
        clock = np.asarray(pairwise.clock_offset_samples, np.float64)
        corrected = raw - clock
        # Matched-filter σ per pair; the dual-REF clock correction adds
        # the same REF variance term as the pairwise path — it isn't
        # stored separately, so propagate the template σs and let the
        # solver's residual scale absorb the shared clock term.
        sigma = np.sqrt(
            toa_std[pairs[:, 0]] ** 2 + toa_std[pairs[:, 1]] ** 2
        )
        # Pair weight: limited by its weaker station, quadratic like
        # the pairwise solve's quality weighting.
        pq = np.minimum(q[pairs[:, 0]], q[pairs[:, 1]])
        wmax = max(pq.max(), 1e-9)
        weights = (pq / wmax) ** 2

        fix = solve_fix(
            lla, corrected / fs, weights=weights, pair_idx=pairs,
            solve_z=cfg.solve_z, tdoa_sigma_s=sigma / fs,
        )
        val_warns, score = _cross_validation(
            corrected, sigma, pairwise, fix, names, pairs, fs
        )
        warnings.extend(val_warns)
        # Escalation trigger (auto mode): a validation rung fired, or
        # any station's match is shaky. PSR < 6 marks the shaky zone:
        # the measured FM-threshold wrong-peaks scored 2.8-4.3 while
        # healthy matches score 8+ (Monte Carlo seeds 31108/32208).
        trouble = score[1] > 0 or bool((q < 6.0).any())
        res = AudioMatchResult(
            station_names=names,
            pair_idx=pairs,
            toa_samples=toa,
            toa_std_samples=toa_std,
            station_quality=q,
            template_tdoa_samples=raw,
            corrected_tdoa_samples=corrected,
            tdoa_seconds=corrected / fs,
            tdoa_std_s=sigma / fs,
            fix=fix,
            pairwise=pairwise,
            covered_fraction=covered,
            lo_offset_hz=(
                None if m.lo_offset_hz is None
                else np.asarray(m.lo_offset_hz, np.float64)
            ),
            warnings=warnings,
            mode_used=domain,
        )
        return res, score, trouble

    if mode in ("audio", "rf"):
        m, extra = run_domain(mode)
        return assemble(mode, m, extra)[0]

    # mode="auto": run BOTH domains and keep the better-validating one.
    # Round-2 auto only escalated to rf when the audio match flunked a
    # validation rung or a station PSR fell below 6 — but a
    # near-threshold audio match can carry a multi-sample bias while
    # every gate stays green (healthy PSR 17/17/11 with a 5.6-sample
    # error, Monte Carlo seed 42008; the linear rf filter read the same
    # scene at 1.5). The rf pass costs ~0.2 s against a 10 s capture
    # cadence, so always measure both and rank by disagreement with the
    # pairwise baseline on the common scale. Ties (both clean) keep the
    # audio result — LO-immune and the sharper estimator when healthy.
    m_a, ex_a = run_domain("audio")
    res_a, score_a, trouble = assemble("audio", m_a, ex_a)
    m_r, ex_r = run_domain("rf")
    res_r, score_r, _ = assemble("rf", m_r, ex_r)
    use_rf = (score_r < score_a if trouble else
              # Audio passed its gates: switch only on a decisive rf
              # advantage, so baseline-noise coin flips don't discard
              # the healthy audio match.
              score_r[0] < 0.5 * score_a[0] and score_a[0] > 0.5)
    chosen = res_r if use_rf else res_a

    def _desc(s: Tuple[float, int]) -> str:
        return f"{s[1]} validation rung(s), worst {s[0]:.2f}x gate"

    if use_rf or trouble:
        chosen.warnings.insert(
            0,
            "auto mode: "
            + ("the audio-domain match looked unreliable"
               if trouble else
               "the rf-domain match cross-validated decisively better")
            + f" ({_desc(score_a)}; min station PSR "
            f"{float(res_a.station_quality.min()):.1f}) — escalated to "
            f"the rf-domain matched filter ({_desc(score_r)}) and kept "
            f"the {'rf' if use_rf else 'audio'} result",
        )
    return chosen
