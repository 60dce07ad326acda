"""The end-to-end TDOA processor: captures → TDOAs → position fix.

Capability parity with processor.go's ProcessTDOA (processor.go:739-929),
rebuilt as one batched device program:

- all three blocks of all stations are correlated in ONE batched jitted
  program: signals stack to ``[3·n_st, L]`` and the per-block station pairs
  become one pair list, so every FFT rides the same XLA computation;
- the reference-signal clock correction the reference left unwired
  (processor.go:853-858 just picks the TGT delays) is implemented: the two
  REF blocks bracket the TGT block, so the per-pair clock offset is
  *interpolated* to the TGT block's midpoint and subtracted, and the known
  reference-transmitter geometry removes the REF propagation term;
- TDOAs are converted to range differences and solved by multi-start
  Levenberg-Marquardt over all pairs (solve/multilateration.py).

Sanity gates mirror PROJECT_NOTES.md:29-32: physical TDOAs for the network
are bounded by baseline/c, so measurements beyond that are flagged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tdoa_tpu.geo import lla_to_ecef, lla_to_enu
from tdoa_tpu.io.datfile import DatCapture, load_dat
from tdoa_tpu.io.stations import StationTable, load_station_table, station_from_filename
from tdoa_tpu.ops.cplx import C, from_complex
from tdoa_tpu.ops.corr import clock_correct_blocks, correlate_pairs_planar
from tdoa_tpu.solve.ghost import DECISION_THRESHOLD_NATS
from tdoa_tpu.solve.multilateration import (
    FixResult,
    rank_candidates_by_power,
    refit_to_candidate,
    solve_fix,
    station_pairs,
)
from tdoa_tpu.utils.constants import (
    DEFAULT_MAX_LAG,
    DEFAULT_SAMPLE_RATE,
    SPEED_OF_LIGHT,
)


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    ref_freq: float
    tgt_freq: float
    sample_rate: float = DEFAULT_SAMPLE_RATE
    max_lag: int = DEFAULT_MAX_LAG
    # Streaming segment length; the 20000-sample search window bounds how
    # small segments can go (resolve_seg shrinks the segment by max_lag
    # to keep the FFT at 2^16).
    seg_len: Optional[int] = 1 << 16
    weighting: str = "ht"  # Hannan-Thomson ML weighting (ops/corr.py)
    clock_correction: bool = True
    mode: str = "iq"  # "iq" raw correlation | "fm" audio-domain correlation
    fm_decim: int = 8  # audio decimation for mode="fm"
    solve_z: bool = False
    # Like the reference's 1 s truncation (processor.go:772-783) but
    # optional: None processes the full capture.
    truncate_samples: Optional[int] = None
    # Multi-emitter resolution: >1 separates up to this many co-channel
    # emitters from the per-pair top-K correlation peaks by TDOA
    # cycle-consistency (solve/association.py) and solves each set.
    multi_emitter: int = 1
    emitter_tol_samples: float = 3.0
    # Joint velocity estimation: run the CAF over the TGT block, remove
    # the clock-drift-induced Doppler measured from the dual REF blocks,
    # and least-squares the emitter velocity at the fix (solve/fdoa.py).
    solve_velocity: bool = False
    caf_seg_len: int = 1 << 13  # Doppler span ±1/(2·T_seg) ≈ ±122 Hz
    caf_n_doppler: int = 64
    caf_max_samples: int = 1 << 21  # cap CAF input (memory/time)
    # Receiver LO-offset compensation ("auto" | "off"). A real TCXO off
    # by d ppm shifts its LO by d·1e-6·f_c (~16 Hz at VHF per 0.1 ppm),
    # smearing EVERY block's full-capture correlation — including the
    # REF blocks the clock correction depends on. "auto" probes the
    # REF1 block with the CAF, solves per-station LO offsets, and
    # derotates all three blocks (scaled by each block's carrier)
    # before the main correlation. Off by default: the probe costs one
    # CAF dispatch, and disciplined-clock deployments don't need it.
    lo_compensation: str = "off"
    # Ghost-ambiguity auto-resolution: when a 3-station fix has two
    # timing-equivalent intersections AND the 1/r received-power
    # ranking (REF-gain-calibrated) is decisive, move the fix to the
    # power-preferred candidate. Off by default — path-loss ranking
    # assumes comparable antennas and free-space propagation, so the
    # swap is an operator opt-in; the ranking itself is always
    # reported in the warning and on fix.candidates_power_score.
    power_disambiguation: bool = False
    # FDOA ghost disambiguation (solve_velocity runs only): both ghost
    # intersections satisfy the TDOAs, but only near the TRUE position
    # do the measured pairwise Dopplers stay consistent with a single
    # emitter velocity — at the ghost the emitter→station unit-vector
    # geometry differs and the linear FDOA fit leaves a residual.
    # Physics, not a propagation assumption, so the decisive swap is on
    # by default (still requires a 3x residual margin); the ranking is
    # always reported in the ghost warning. With 3 stations the fit has
    # one dof and the residual alone can be inconclusive — the ghost
    # then "explains" the Dopplers only with an absurd velocity (the
    # distant intersection's unit-vector differences shrink, so |v|
    # inflates ~1/geometry; observed 1944 m/s vs a 105 m/s truth): a
    # candidate whose fitted speed exceeds max_emitter_speed_mps loses
    # to one within it.
    fdoa_disambiguation: bool = True
    # Speed plausibility ceiling for the FDOA ghost ranking ONLY (never
    # gates the velocity solve itself). 700 m/s covers every aircraft
    # including military jets at dash speed.
    max_emitter_speed_mps: float = 700.0
    # Decision threshold (nats of posterior odds) for the unified
    # ghost posterior (solve/ghost.py): the fix moves to the leading
    # candidate only when its margin over the runner-up clears this,
    # else the processor abstains (warning + candidate list). Default
    # IS solve.ghost.DECISION_THRESHOLD_NATS (imported, not copied —
    # it was calibrated as a pair with POWER_LOG_SIGMA on the
    # Monte Carlo ghost population, scripts/ghost_calibration.py, and
    # a recalibration there must not leave a stale copy here).
    ghost_threshold_nats: float = DECISION_THRESHOLD_NATS
    # Coverage prior (lat°, lon°, radius m): operator knowledge of the
    # surveillance area. On an ambiguous fix, a UNIQUE candidate inside
    # the prior is selected outright (hard knowledge beats the advisory
    # power ranking); zero or multiple in-prior candidates are reported
    # and the fix is left alone.
    prior: Optional[Tuple[float, float, float]] = None
    # In-peak multipath mitigation (dsp/multipath.py): calibrated
    # echo-bias σ inflation (the ellipse covers the residual echo bias
    # it used to ignore) + two-path echo diagnosis in the warning. The
    # TDOAs themselves are never replaced — every replacement estimator
    # measured worse than the plain GCC-HT read (module docstring).
    # Off = detector warns only (the round-2 behavior).
    multipath_mitigation: bool = True
    # Leave-stations-out outlier rejection: when the solved TDOA set
    # is internally inconsistent and the network has >= 5 stations,
    # re-solve with each station's pairs removed; if EXACTLY ONE
    # exclusion restores consistency, that station is an outlier
    # (multipath lock, interference) and is excluded from the fix.
    # With >= 6 stations, pairs of exclusions are tried the same way
    # when no single one works (two outliers). 5 is a floor, not a
    # tuning choice: a single-station timing bias adds one unknown
    # against the n-1 independent arrival differences, so at n=4 every
    # leave-one-out subproblem is exactly solvable and the test cannot
    # identify the bad station. See _reject_outliers.
    outlier_rejection: bool = True


@dataclasses.dataclass
class TDOAResult:
    fix: FixResult
    station_names: List[str]
    pair_idx: np.ndarray  # [m, 2]
    tgt_delay_samples: np.ndarray  # [m] raw TGT correlation delays
    ref_delay_samples: np.ndarray  # [m, 2] raw REF-block delays (blocks 1, 3)
    clock_offset_samples: np.ndarray  # [m] interpolated pair clock offsets
    corrected_tdoa_samples: np.ndarray  # [m] what the solver consumed
    tdoa_seconds: np.ndarray  # [m]
    quality: np.ndarray  # [m] TGT peak-to-sidelobe ratios
    peak_value: np.ndarray  # [m] TGT correlation peaks
    tdoa_std_s: Optional[np.ndarray] = None  # [m] 1σ TDOA errors, seconds
    # [m] relative clock-rate difference per pair (station j vs i), ppm,
    # measured from the two REF blocks' delay difference — the drift
    # diagnostic the dual-REF capture format makes free.
    clock_drift_ppm: Optional[np.ndarray] = None
    warnings: List[str] = dataclasses.field(default_factory=list)
    # Per-emitter fixes from multi-emitter association (config
    # multi_emitter > 1); strongest emitter first. None when disabled.
    emitters: Optional[List["EmitterFix"]] = None
    # Emitter velocity from the CAF + FDOA solve (config solve_velocity):
    # ENU m/s at the fix, rms Doppler residual, per-pair FDOA (Hz,
    # clock-drift-corrected). None when disabled.
    velocity_enu: Optional[np.ndarray] = None
    velocity_residual_hz: Optional[float] = None
    velocity_sigma_enu: Optional[np.ndarray] = None  # 1σ per axis, m/s
    fdoa_hz: Optional[np.ndarray] = None
    # Stations excluded from the fix by leave-one-station-out outlier
    # rejection (config outlier_rejection, >= 5-station networks).
    # Their measurements remain in the per-pair arrays; their weights
    # were zeroed for the solve. None when nothing was excluded.
    excluded_stations: Optional[List[str]] = None
    # [m] the relative per-pair weights the final solve actually used:
    # quadratic quality weighting, noise-floor gate, and any outlier
    # station's pairs zeroed. Downstream re-solves (the stream
    # tracker) must use these, not the raw TDOA vector.
    solve_weights: Optional[np.ndarray] = None
    # In-peak multipath handling (dsp/multipath.py). The TDOAs are NOT
    # re-estimated — every replacement estimator measured WORSE than
    # the plain GCC-HT peak read (see the module docstring's evidence
    # table); mitigation is honest accounting instead: tdoa_std_s
    # carries the calibrated echo-bias inflation, and these fields
    # report the detector verdicts and the echo's measured geometry.
    multipath_flagged: Optional[np.ndarray] = None  # [m] bool; None if
    #                                                 the detector never ran
    # Per-pair σ addend (samples) from the echo-bias accounting —
    # already folded into tdoa_std_s; reported so callers can see how
    # much of the budget is echo bias vs noise.
    multipath_sigma_samples: Optional[np.ndarray] = None  # [m]
    # Decisive two-path diagnoses: the echo's excess delay (samples,
    # NaN where undiagnosed) and relative amplitude. Excess path
    # length in meters = separation / sample_rate * c.
    multipath_echo_separation_samples: Optional[np.ndarray] = None  # [m]
    multipath_echo_ratio: Optional[np.ndarray] = None  # [m]
    # Unified ghost posterior (solve/ghost.py GhostVerdict) when the
    # fix was ambiguous: per-candidate log-odds (aligned with
    # fix.candidates_lla), per-signal components, and whether the
    # calibrated threshold decided the swap. None when unambiguous.
    ghost: Optional["GhostVerdict"] = None


@dataclasses.dataclass
class HostCapture:
    """Host-resident capture handle for the overlapped-ingest path
    (pipeline/ingest.py): the station's packed-u16 view of its .dat
    bytes (io.datfile.iq_bytes_as_u16 over a read-only mmap — nothing
    is decoded or transferred until the chunk pipeline streams it) plus
    its per-block sample count."""

    u16: np.ndarray  # [3·block_len] packed I/Q words
    block_len: int

    def subsample_planar(self, block: int, limit: int = 1 << 20,
                         run: int = 1 << 18) -> C:
        """Decode ``limit`` samples of one block (0=REF1, 1=TGT,
        2=REF2) as ``limit // run`` CONTIGUOUS runs evenly spaced
        across the block — for the eager analyses (received-power
        ghost ranking). Contiguous runs, not a bare stride: strided
        decimation has no anti-alias filter, so out-of-band energy
        folds into the Welch PSD `_station_signal_power` computes, and
        per-station strides (block_len is per station) land the common
        emitter band on different bins per station. Runs of 2¹⁸ keep
        every downstream 4096-sample Welch segment inside one
        contiguous span (joints fall on segment boundaries), and every
        station returns exactly ``limit`` samples regardless of its
        block length. Mean |x|² still samples the whole block (the
        runs are spread), so keyed/intermittent emitters average the
        same way the stride did."""
        from tdoa_tpu.io.datfile import u16_to_iq_planar

        base = block * self.block_len
        if self.block_len <= limit:
            sl = self.u16[base:base + self.block_len]
            return u16_to_iq_planar(jnp.asarray(np.ascontiguousarray(sl)))
        nruns = max(1, limit // run)
        span = self.block_len - run
        parts = [
            self.u16[base + (span * k) // max(nruns - 1, 1):
                     base + (span * k) // max(nruns - 1, 1) + run]
            for k in range(nruns)
        ]
        return u16_to_iq_planar(jnp.asarray(np.concatenate(parts)))


def _stack_station_subsamples(subs: "list[C]") -> C:
    """Stack per-station subsample_planar outputs into one [n_st, L]
    planar block. subsample_planar returns exactly ``limit`` samples
    only for stations whose block exceeds the limit; a station below
    it returns its whole (shorter) block, so a capture set straddling
    the limit is ragged and jnp.stack would raise (advisor round-4,
    low). Trim every station to the shortest — truncation keeps the
    power estimates honest (every retained sample is real data, and
    the Welch estimator drops any final partial segment itself)."""
    L = min(s.re.shape[0] for s in subs)
    return C(
        jnp.stack([s.re[:L] for s in subs]),
        jnp.stack([s.im[:L] for s in subs]),
    )


@dataclasses.dataclass
class EmitterFix:
    """One resolved co-channel emitter: its associated TDOA set + fix."""

    fix: FixResult
    tdoa_samples: np.ndarray  # [m] clock-corrected, associated per pair
    peak_value: np.ndarray  # [m] correlation peak heights of the set
    max_inconsistency_samples: float  # worst cycle-consistency residual
    # Per-emitter Doppler/velocity (solve_velocity + multi_emitter):
    # the CAF surface is read at THIS emitter's lag per pair, so mixed
    # windows get attributable FDOA. None when unavailable.
    fdoa_hz: Optional[np.ndarray] = None  # [m] drift-corrected
    velocity_enu: Optional[np.ndarray] = None  # [3] m/s
    velocity_sigma_enu: Optional[np.ndarray] = None  # [3] 1σ m/s
    # [m] the per-pair weights this emitter's solve used (quadratic
    # associated-peak weighting) — downstream re-solves (the stream
    # tracker) must use them, mirroring TDOAResult.solve_weights.
    solve_weights: Optional[np.ndarray] = None


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_lag", "seg_len", "weighting", "clock_correction", "mode",
        "fm_decim", "sample_rate", "fft_precision", "seg_batch",
    ),
)
def process_blocks(
    ref1: C,  # [n_st, L] planar complex
    tgt: C,
    ref2: C,
    pair_idx: jax.Array,  # [m, 2]
    ref_geo_tdoa: jax.Array,  # [m] reference-tx geometric TDOA, samples
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "phat",
    clock_correction: bool = True,
    mode: str = "iq",  # "iq" | "fm"
    fm_decim: int = 8,
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    fft_precision: str = "f32",
    seg_batch: int = 1,
):
    """The fused device program: 3 blocks × all pairs → corrected TDOAs.

    Returns (corrected_tdoa, tgt_delay, ref_delays [m,2], clock, quality,
    peak, corrected_std, tgt_corr_window, tgt_std,
    block_corr_windows_complex [2,3,m,W]), all delays/σs in IQ
    samples; ``tgt_std`` is the TGT block's own σ, before the REF
    clock-correction variance folds into ``corrected_std``. All three blocks correlate in one batched
    call; DC removal happens on-device (the standard preprocessing of
    processor.go:469-499 — the remaining filter cascade there exists to
    prop up a weak time-domain correlator and is superseded by GCC
    weighting). Fully planar (no complex dtype on device).

    ``mode="fm"`` correlates the FM-demodulated *audio* instead of raw
    IQ — the "FM audio demodulation to aid correlation" capability the
    reference documents (README.md:3-7) but never wired into its
    processor. Audio correlation is immune to carrier phase/LO offsets
    (they become DC, removed on demod) and concentrates all energy into
    the audio band; timing resolution is bandwidth-limited, so delays
    come back ``fm_decim`` × coarser before sub-sample refinement.
    """
    from tdoa_tpu.dsp.fm import fm_demodulate

    n_st = ref1.re.shape[0]
    m = pair_idx.shape[0]

    xr = jnp.concatenate([ref1.re, tgt.re, ref2.re], axis=0)  # [3*n_st, L]
    xi = jnp.concatenate([ref1.im, tgt.im, ref2.im], axis=0)
    xr = xr - jnp.mean(xr, axis=-1, keepdims=True)  # DC removal
    xi = xi - jnp.mean(xi, axis=-1, keepdims=True)
    # Pair lists for each block, offset into the stacked station axis.
    offsets = jnp.arange(3, dtype=jnp.int32)[:, None, None] * n_st
    all_pairs = (pair_idx[None, :, :] + offsets).reshape(3 * m, 2)

    if mode == "fm":
        audio = fm_demodulate(C(xr, xi), sample_rate, decim=fm_decim)
        x_corr = C(audio, jnp.zeros_like(audio))
        scale = float(fm_decim)
        max_lag_c = max(max_lag // fm_decim + 2, 16)
        seg_c = None if seg_len is None else max(seg_len // fm_decim, 4 * max_lag_c)
        # Audio-domain correlation must be PLAIN (power-weighted), not
        # GCC-whitened: demodulated audio occupies only the low ~20% of
        # the decimated band, and PHAT/HT weight every bin equally — the
        # empty bins carry segment-edge leakage that is COMMON to all
        # channels (anchored at window edges), so whitening votes the
        # peak to lag 0 regardless of the true delay (measured: true
        # 12-sample audio shift reported as 1 under ht/phat, exact
        # under "none"). Oversampled-signal GCC is a known failure
        # mode; plain correlation weights bins by power and is the
        # right estimator for audio pattern matching.
        weighting = "none"
    elif mode == "iq":
        from tdoa_tpu.ops.corr import auto_seg_len

        x_corr = C(xr, xi)
        scale = 1.0
        max_lag_c = max_lag
        # Short captures: shrink the segment so the Welch average still
        # holds ≥8 segments (better HT coherence + a multi-dof split σ;
        # measured ~1.9x lower delay-error std on 131072-sample noisy
        # blocks). Long captures keep the configured segment.
        seg_c = auto_seg_len(xr.shape[-1], max_lag, seg_len)
    else:
        raise ValueError(f"unknown processing mode: {mode!r}")

    res = correlate_pairs_planar(
        x_corr, all_pairs, max_lag=max_lag_c, seg_len=seg_c,
        weighting=weighting, fft_precision=fft_precision,
        seg_batch=seg_batch,
    )
    return clock_correct_blocks(
        res.delay.reshape(3, m) * jnp.float32(scale),
        res.delay_std.reshape(3, m) * jnp.float32(scale),
        res.quality.reshape(3, m),
        res.peak_value.reshape(3, m),
        res.corr.reshape(3, m, -1),
        res.corr_re.reshape(3, m, -1),
        res.corr_im.reshape(3, m, -1),
        ref_geo_tdoa, clock_correction,
    )


# Lobe-shape drift detector: moved to dsp/multipath.py (the detector
# and the mitigation share calibration); re-exported here for callers.
from tdoa_tpu.dsp.multipath import lobe_centroid_drift as _lobe_centroid_drift  # noqa: E402
from tdoa_tpu.solve.ghost import GhostVerdict  # noqa: E402


def _horiz_m(a_lat, a_lon, b_lat, b_lon, elev) -> float:
    """Horizontal ENU separation in meters between two lat/lon points
    (both evaluated at ``elev`` so the measure is purely horizontal)."""
    return float(np.linalg.norm(lla_to_enu(
        np.array([a_lat, a_lon, elev]), np.array([b_lat, b_lon, elev])
    )[:2]))


def _station_mean_power(x: C) -> np.ndarray:
    """Per-station mean |x|² from a strided subsample (≤1M samples per
    station) — cheap enough to run eagerly on the rare ambiguous-fix
    path without touching the hot pipeline."""
    n = int(x.re.shape[1])
    step = max(1, n // (1 << 20))
    re = x.re[:, ::step]
    im = x.im[:, ::step]
    return np.asarray(jnp.mean(re * re + im * im, axis=1), np.float64)


def _station_signal_power(x: C, chunk: int = 1 << 18) -> np.ndarray:
    """Per-station SIGNAL power: Welch PSD, median noise floor, and an
    UNCLIPPED floor-subtracted sum over the emitter's common signal
    band (identified on the highest-SNR station).

    The 1/r ghost ranking needs the signal AMPLITUDE profile across
    stations, but mean |x|² measures signal+noise — and at low SNR the
    noise flattens the profile, which systematically favors the
    DISTANT ghost (far away, every dᵢ is similar, so a flat amplitude
    profile looks "consistent" with 1/r from there). Measured on the
    round-4 ghost calibration base: all five noisy-regime ghosts had
    the raw-power ranking prefer the 10-60 km ghost by 3.8-11.7 nats.

    Two estimator subtleties, both measured on that base:
    - The floor must be subtracted UNCLIPPED. A per-bin
      max(psd−floor, 0) sum keeps the positive noise fluctuations and
      floors a weak station's estimate at ~5-10% of its noise power —
      seed 42640's 1.15 km-vs-12 km profile (true contrast 116×) read
      only 10× through that residue and still preferred the ghost by
      11 nats. Unclipped subtraction is unbiased; its noise is ~N/√(S·B)
      per station — an order below the profile contrasts that matter.
    - The sum runs over the COMMON signal band only (bins where the
      best station clears the floor by 5 estimator σ, i.e. the same
      emitter's occupancy at every station), so a weak station's
      out-of-band noise never enters its estimate at all.

    Estimates are floored at their own 1σ measurement noise (an
    honest "≤ detection limit" for a station whose signal is genuinely
    unmeasurable in the capture) and fall back to mean power when no
    station shows a detectable band (the ranking then degrades to the
    raw behavior instead of inventing structure)."""
    n = int(x.re.shape[1])
    seg = 4096
    take = min(n, chunk)
    off = (n - take) // 2
    nseg = max(1, take // seg)
    re = np.asarray(x.re[:, off:off + nseg * seg], np.float64)
    im = np.asarray(x.im[:, off:off + nseg * seg], np.float64)
    z = (re + 1j * im).reshape(re.shape[0], nseg, seg)
    psd = np.mean(np.abs(np.fft.fft(z, axis=-1)) ** 2, axis=1) / seg
    floor = np.median(psd, axis=-1, keepdims=True)  # [n_st, 1]
    # Detection z-score per bin: Welch averaging over nseg segments
    # puts the noise-bin std at ~floor/√nseg.
    zscore = (psd - floor) / np.maximum(floor / np.sqrt(nseg), 1e-30)
    band = (zscore > 5.0).any(axis=0)  # [seg] union over stations
    if not band.any():
        return _station_mean_power(x)
    nb = int(np.count_nonzero(band))
    sig = np.sum(psd[:, band] - floor, axis=-1) / seg
    # 1σ noise of each station's band-sum estimate (detection limit).
    lim = floor[:, 0] * np.sqrt(nb / nseg) / seg
    return np.maximum(sig, lim)


def _derotate(
    block: C,
    shifts_hz: np.ndarray,  # [n_st] per-station frequency shifts
    sample_rate: float,
    lim: Optional[int] = None,
) -> C:
    """Counter-rotate each station's block by its frequency shift.

    DC is removed BEFORE the rotation: rotated DC becomes a coherent
    in-band tone that later mean-subtraction cannot remove, and PHAT
    whitening then elevates it into a delay-peak bias.
    """
    n = block.re.shape[1] if lim is None else lim
    ang = (
        -2.0 * jnp.pi
        * jnp.asarray(shifts_hz, jnp.float32)[:, None]
        * (jnp.arange(n) / sample_rate)
    )
    cr_, sr_ = jnp.cos(ang), jnp.sin(ang)
    br = block.re[:, :n].astype(jnp.float32)
    bi = block.im[:, :n].astype(jnp.float32)
    br = br - jnp.mean(br, axis=-1, keepdims=True)
    bi = bi - jnp.mean(bi, axis=-1, keepdims=True)
    return C(br * cr_ - bi * sr_, br * sr_ + bi * cr_)


def _deramp_correlate(
    tgt: C,
    s_dop: np.ndarray,  # [n_st] per-station frequency shifts, Hz
    pairs: np.ndarray,
    lim: int,
    max_lag: int,
    seg_len,
    weighting: str,
    sample_rate: float,
):
    """Counter-rotate the TGT block (see _derotate) and re-run the
    plain correlator over the first ``lim`` samples — truncated because
    a mover's envelope delay drifts: over a long capture the full-block
    peak smears/walks while a ~1 s window keeps the drift below half a
    sample at aircraft speeds."""
    from tdoa_tpu.ops.corr import auto_seg_len

    yd = _derotate(tgt, s_dop, sample_rate, lim=lim)
    # Same segment auto-shrink as the primary path (process_blocks
    # mode="iq"): the deramp window is lim samples — often much shorter
    # than the capture — and its σ feeds the adoption gate against the
    # primary's calibrated K=4 split σ. Without the shrink, a short
    # window lands on S≤2 (the 1-dof half-split whose draws can read
    # near zero) or S=1 (model σ alone, 10-70x optimistic on weak
    # signals), and the gate compares incommensurate estimators.
    return correlate_pairs_planar(
        yd,
        jnp.asarray(pairs),
        max_lag=max_lag,
        seg_len=auto_seg_len(lim, max_lag, seg_len),
        weighting=weighting,
    )


class TDOAProcessor:
    """High-level orchestrator mirroring the reference CLI contract
    (``processor ref_freq target_freq csv dat1 dat2 dat3...``,
    processor.go:1047-1051)."""

    def __init__(self, config: ProcessorConfig, stations: StationTable):
        self.config = config
        self.stations = stations
        # Optional per-stage wall-clock accounting (utils/profiling.py);
        # attach a StageTimer to get load/correlate/solve splits with
        # device-synchronized edges.
        self.timer = None

    @classmethod
    def from_csv(
        cls, ref_freq: float, tgt_freq: float, csv_path: str, **cfg
    ) -> "TDOAProcessor":
        table = load_station_table(csv_path, reference_freq=ref_freq)
        return cls(ProcessorConfig(ref_freq=ref_freq, tgt_freq=tgt_freq, **cfg), table)

    def _ref_geo_tdoa_samples(self, names: Sequence[str], pairs: np.ndarray) -> np.ndarray:
        """Geometric REF-transmitter TDOA per pair, in samples. Zero when
        the reference transmitter's position is unknown — the clock
        correction then still cancels each pair's clock offset but leaves
        the REF transmitter's per-pair geometric TDOA (up to baseline/c)
        in every corrected TDOA; process_captures surfaces a warning."""
        if self.stations.reference_tx is None:
            return np.zeros(len(pairs))
        lla = self.stations.lla_array(names)
        st = lla_to_ecef(lla)
        tx = lla_to_ecef(self.stations.reference_tx.lla())
        d = np.linalg.norm(st - tx, axis=-1)
        tau = d / SPEED_OF_LIGHT * self.config.sample_rate
        return tau[pairs[:, 1]] - tau[pairs[:, 0]]

    def _reject_outliers(
        self,
        fix: FixResult,
        w: np.ndarray,
        tdoa_s: np.ndarray,
        tdoa_std_s: np.ndarray,
        names: Sequence[str],
        pairs: np.ndarray,
        lla: np.ndarray,
        worst_pair,  # callable(fix, weights) -> (score, pair index)
        warnings: List[str],
    ) -> Tuple[FixResult, np.ndarray, List[str]]:
        """Leave-stations-out outlier rejection on an inconsistent set.

        One corrupted station (multipath lock, co-channel interference)
        gives clean, confident peaks at wrong delays, poisoning n-1
        pairs in a way the per-pair quality gate cannot see. With >= 5
        stations the remaining network keeps a consistency redundancy
        (n-1 independent arrival differences vs 2 position unknowns),
        so excluding the bad station restores consistency while
        excluding any good one does not. An exclusion is adopted only
        when it is UNIQUE in restoring consistency; when no single
        exclusion works and >= 6 stations are active, station *pairs*
        are tried the same way (two outliers). Anything else stays
        advisory: a warning reports the per-exclusion residuals and the
        fix is left alone.
        """
        cfg = self.config
        n = len(names)
        if n < 5:
            return fix, w, []

        def solve_without(excl):
            mask = np.array(
                [float(i not in excl and j not in excl) for i, j in pairs]
            )
            w_x = w * mask
            if np.count_nonzero(w_x) < 3:
                return None
            return w_x, solve_fix(
                lla, tdoa_s, weights=w_x, pair_idx=pairs,
                solve_z=cfg.solve_z, tdoa_sigma_s=tdoa_std_s,
            )

        def consistent(t):
            excl_w, excl_fix = t[1]
            return worst_pair(excl_fix, excl_w)[0] <= 1.0

        tried = [
            ((s,), r) for s in range(n) if (r := solve_without({s}))
        ]
        passing = [t for t in tried if consistent(t)]
        if not passing and n >= 6:
            # Two outliers: no single exclusion can restore consistency,
            # but a unique pair of exclusions can (the remaining >= 4
            # stations keep one redundancy).
            tried = [
                ((a, b), r)
                for a in range(n) for b in range(a + 1, n)
                if (r := solve_without({a, b}))
            ]
            passing = [t for t in tried if consistent(t)]
        if len(passing) != 1:
            detail = ", ".join(
                f"without {'+'.join(names[s] for s in excl)}: "
                f"{r[1].rms_residual_m:.0f} m"
                for excl, r in tried
            )
            warnings.append(
                f"leave-one-station-out test is inconclusive "
                f"({len(passing)} exclusions restore consistency; "
                f"rms {detail}) — no station excluded"
            )
            return fix, w, []
        excl, (w_x, fix_x) = passing[0]
        excluded = [names[s] for s in excl]
        plural = len(excluded) > 1
        warnings.append(
            f"station{'s' if plural else ''} {' and '.join(excluded)} "
            f"excluded as outlier{'s' if plural else ''}: "
            f"{'their' if plural else 'its'} pairs are inconsistent "
            f"with the rest of the network (rms "
            f"{fix.rms_residual_m:.0f} m with "
            f"{'them' if plural else 'it'}, "
            f"{fix_x.rms_residual_m:.0f} m without) — suspect multipath "
            f"lock or co-channel interference there"
        )
        return fix_x, w_x, excluded

    def _analyze_fix(
        self,
        fix: FixResult,
        w: np.ndarray,
        tdoa_s: np.ndarray,
        tdoa_std_s: np.ndarray,
        names: Sequence[str],
        pairs: np.ndarray,
        lla: np.ndarray,
        tgt: C,
        ref1: C,
        warnings: List[str],
        deramp_note: str = "",
        fdoa_hz: Optional[np.ndarray] = None,
    ) -> Tuple[FixResult, np.ndarray, List[str], Optional[GhostVerdict]]:
        """Post-solve analysis of the FINAL TDOA set: consistency gate,
        outlier rejection, ghost-ambiguity detection (the unified
        prior + FDOA + power posterior, solve/ghost.py), and the
        out-of-prior warning. Must run after any step that can replace
        the fix/weights wholesale (the Doppler deramp re-solve).
        ``fdoa_hz``: the CAF's per-pair differential Dopplers (emitter
        motion only, drift-corrected), when solve_velocity measured
        them. Returns the possibly-updated
        (fix, weights, excluded_station_names, ghost_verdict)."""
        cfg = self.config
        # Mutually inconsistent TDOAs leave residuals the per-pair
        # quality gate cannot see: a co-channel interferer or strong
        # multipath produces clean, confident peaks on DIFFERENT
        # emitters/paths. The test is PER PAIR and normalized by each
        # pair's own 1σ: a pair whose residual at the fix exceeds
        # max(5σ, 100 m) is inconsistent beyond its error bar. (An
        # aggregate rms-vs-median-σ gate fails exactly when needed:
        # corruption that inflates the honest split-half σs raises the
        # aggregate gate until a 6 km mixed-emitter residual passes.)
        gate_m = np.maximum(
            5.0 * np.asarray(tdoa_std_s, np.float64) * SPEED_OF_LIGHT,
            100.0,
        )
        rd_m = np.asarray(tdoa_s, np.float64) * SPEED_OF_LIGHT

        def worst_pair(f: FixResult, weights) -> Tuple[float, int]:
            """(max |residual|/gate over active pairs, argmax pair)."""
            st_enu = lla_to_enu(lla, f.origin_lla)
            di = np.linalg.norm(f.enu - st_enu[pairs[:, 0]], axis=-1)
            dj = np.linalg.norm(f.enu - st_enu[pairs[:, 1]], axis=-1)
            r = np.abs((dj - di) - rd_m) / gate_m
            r = np.where(np.asarray(weights, np.float64) > 0.0, r, 0.0)
            k = int(np.argmax(r))
            return float(r[k]), k

        excluded: List[str] = []
        if cfg.outlier_rejection and worst_pair(fix, w)[0] > 1.0:
            fix, w, excluded = self._reject_outliers(
                fix, w, tdoa_s, tdoa_std_s, names, pairs, lla,
                worst_pair, warnings,
            )
        score, k_bad = worst_pair(fix, w)
        if score > 1.0:
            i, j = pairs[k_bad]
            warnings.append(
                f"TDOA set is internally inconsistent (pair "
                f"{names[i]}-{names[j]} residual {score * gate_m[k_bad]:.0f} "
                f"m vs its {gate_m[k_bad]:.0f} m error-bar gate): suspect "
                f"co-channel interference, multipath, or a wrong station "
                f"assignment{deramp_note}"
            )
        sigma_m = float(np.median(np.asarray(tdoa_std_s))) * SPEED_OF_LIGHT

        def runnerup(f: FixResult):
            """(location, rms, horizontal separation) of candidate #2."""
            second = f.candidates_lla[1]
            return (
                second,
                float(f.candidates_rms[1]),
                _horiz_m(second[0], second[1], f.lat, f.lon, f.elev),
            )

        # Ghost ambiguity: with 3 stations TDOA hyperbolas can intersect
        # TWICE, and both intersections satisfy every pair exactly — the
        # residual cannot choose (Monte Carlo found a silent 548 m miss
        # whose runner-up candidate sat 8 m from truth). When a distant
        # second solution fits within the measurement noise of the best,
        # the fix is genuinely ambiguous and must say so. Three physical
        # signals can still choose — operator prior, differential-
        # Doppler consistency, received-power consistency — combined
        # into ONE posterior-odds score (solve/ghost.py) whose
        # calibrated nats threshold drives the single swap decision
        # (round 3 ran them as a cascade of separately-thresholded
        # rules, each blind to the others' evidence).
        ghost_verdict = None
        if (fix.candidates_lla is not None
                and len(fix.candidates_lla) > 1
                and fix.candidates_rms is not None):
            second, rms2, sep = runnerup(fix)
            ell_a = fix.ellipse[0] if fix.ellipse is not None else 0.0
            close_fit = rms2 <= max(
                2.0 * fix.rms_residual_m, 3.0 * sigma_m, 5.0
            )
            if close_fit and sep > max(100.0, 3.0 * ell_a):
                from tdoa_tpu.solve.ghost import ghost_posterior

                k_cand = len(fix.candidates_lla)
                n_active = int(np.count_nonzero(
                    np.asarray(w, np.float64) > 0))
                # ---- evidence, all on the CURRENT candidate order ----
                # Received power: timing cannot choose between the
                # intersections, but 1/r path loss can lean — the true
                # location's distances must match the received
                # amplitude profile (the REF block calibrates
                # per-station gain differences away, possible only when
                # the REF transmitter position is known).
                ref_tx = self.stations.reference_tx
                fix.candidates_power_score = rank_candidates_by_power(
                    fix.candidates_lla,
                    lla,
                    _station_signal_power(tgt),
                    ref_power=(
                        None if ref_tx is None
                        else _station_signal_power(ref1)
                    ),
                    ref_tx_lla=(
                        None if ref_tx is None else ref_tx.lla()
                    ),
                )
                # Coverage prior: operator knowledge of the
                # surveillance area. Fed to the posterior only when it
                # can actually discriminate (≥1 candidate inside) — a
                # prior excluding ALL candidates is evidence of a prior
                # mismatch, not of either candidate.
                prior_dist = prior_radius = None
                n_inside = None
                if cfg.prior is not None:
                    p_lat, p_lon, p_rad = cfg.prior
                    prior_dist = np.array([
                        _horiz_m(c[0], c[1], p_lat, p_lon, fix.elev)
                        for c in fix.candidates_lla
                    ])
                    prior_radius = float(p_rad)
                    n_inside = int(
                        np.count_nonzero(prior_dist <= prior_radius)
                    )
                # FDOA: both intersections satisfy the TDOAs, but the
                # measured pairwise Dopplers fit a single emitter
                # velocity only where the emitter→station geometry is
                # the true one — and a ghost often "fits" only via an
                # unphysical speed (the distant intersection's
                # unit-vector differences shrink, inflating |v|). Runs
                # only on CAF-significant Doppler (the caller's gate);
                # the speed barrier works even on an exactly-determined
                # fit, so only >= n_dim_v active pairs are required.
                fdoa_res = speeds = None
                fdoa_dof = 0
                n_dim_v = 3 if cfg.solve_z else 2
                if (fdoa_hz is not None and cfg.fdoa_disambiguation
                        and n_active >= n_dim_v):
                    from tdoa_tpu.solve.fdoa import solve_velocity_enu

                    nu_g = np.asarray(fdoa_hz, np.float64)
                    st_g = lla_to_enu(lla, fix.origin_lla)
                    sols = [
                        solve_velocity_enu(
                            st_g, pairs,
                            lla_to_enu(np.asarray(c, np.float64),
                                       fix.origin_lla),
                            nu_g, cfg.tgt_freq, weights=w,
                            solve_z=cfg.solve_z,
                        )
                        for c in fix.candidates_lla
                    ]
                    fdoa_res = np.array([s.residual_hz for s in sols])
                    speeds = np.array([s.speed for s in sols])
                    fdoa_dof = max(0, n_active - n_dim_v)

                # ---- one posterior from everything ----
                def posterior(with_power: bool):
                    return ghost_posterior(
                        k_cand,
                        rms_m=np.asarray(fix.candidates_rms, np.float64),
                        sigma_m=sigma_m,
                        n_pairs_active=n_active,
                        power_scores=(
                            fix.candidates_power_score if with_power
                            else None
                        ),
                        n_stations=len(names),
                        fdoa_resid_hz=fdoa_res,
                        fdoa_dof=fdoa_dof,
                        speeds_mps=speeds,
                        max_speed_mps=cfg.max_emitter_speed_mps,
                        prior_dist_m=(
                            prior_dist if n_inside else None
                        ),
                        prior_radius_m=prior_radius,
                        threshold_nats=cfg.ghost_threshold_nats,
                    )

                verdict = posterior(with_power=True)
                # Power evidence may MOVE the fix only with the opt-in
                # flag (power_disambiguation — it rests on free-space
                # propagation assumptions the other signals don't
                # need): without it, the decision stands on the
                # prior/FDOA/timing evidence ALONE — disagreeing power
                # evidence stays visible in the reported posterior but
                # cannot veto the swap (an earlier form required
                # actionable.best == verdict.best, which let
                # uncalibrated power scores silently pin a
                # prior/FDOA-decided fix to the wrong intersection).
                no_power = posterior(with_power=False)
                actionable = (
                    verdict if cfg.power_disambiguation else no_power
                )
                swap_to = actionable.best if actionable.decided else 0
                # "Power moved the fix" only when power was PIVOTAL —
                # the power-free posterior would NOT have made the same
                # decision (not merely when power evidence existed:
                # that labeled prior-driven swaps as power-driven).
                power_moved = bool(
                    swap_to != 0 and cfg.power_disambiguation
                    and not (no_power.decided
                             and no_power.best == swap_to)
                )
                if swap_to != 0:
                    perm = np.asarray(
                        [swap_to] + [i for i in range(k_cand)
                                     if i != swap_to]
                    )
                    fix = refit_to_candidate(
                        fix, swap_to, lla, pairs,
                        weights=w, tdoa_sigma_s=tdoa_std_s,
                    )
                    # Keep every evidence array aligned with the
                    # reported candidate order (refit_to_candidate
                    # already reorders the fix's own arrays). The
                    # reported posterior's ``best`` follows its own
                    # argmax through the permutation — usually 0 (the
                    # swapped-to candidate), but honestly non-zero when
                    # power evidence disagreed with a power-free
                    # decision.
                    verdict = dataclasses.replace(
                        verdict,
                        log_odds=verdict.log_odds[perm],
                        best=int(np.nonzero(perm == verdict.best)[0][0]),
                        components={k2: v[perm] for k2, v
                                    in verdict.components.items()},
                    )
                    if prior_dist is not None:
                        prior_dist = prior_dist[perm]
                    if fdoa_res is not None:
                        fdoa_res = fdoa_res[perm]
                        speeds = speeds[perm]
                    second, rms2, sep = runnerup(fix)
                ghost_verdict = verdict

                # ---- per-signal notes (evidence the posterior saw,
                # in the reported candidate order) ----
                prior_txt = ""
                if prior_dist is not None:
                    if n_inside == 1:
                        prior_txt = (
                            f"; coverage prior "
                            f"({prior_radius / 1000.0:.0f} km around "
                            f"{cfg.prior[0]:.4f},{cfg.prior[1]:.4f}) "
                            f"selects the only in-prior solution"
                        )
                    elif n_inside == 0:
                        prior_txt = (
                            "; coverage prior excludes ALL candidates "
                            "— suspect geometry or a prior mismatch"
                        )
                    else:
                        prior_txt = (
                            f"; coverage prior keeps {n_inside} "
                            f"candidates — inconclusive"
                        )
                fdoa_txt = ""
                if fdoa_res is not None:
                    ll_f = verdict.components.get("fdoa")
                    k_f = int(np.argmax(ll_f))
                    m_f = float(ll_f[k_f] - np.delete(ll_f, k_f).max())
                    pref_f = ("the primary" if k_f == 0
                              else f"candidate #{k_f + 1}")
                    if m_f >= cfg.ghost_threshold_nats:
                        fdoa_txt = (
                            f"; differential-Doppler consistency "
                            f"selects {pref_f} solution (fit residuals "
                            f"{'/'.join(f'{r:.2f}' for r in fdoa_res)}"
                            f" Hz, fitted speeds "
                            f"{'/'.join(f'{s:.0f}' for s in speeds)}"
                            f" m/s)"
                        )
                    else:
                        fdoa_txt = (
                            f"; differential-Doppler consistency is "
                            f"inconclusive (residuals "
                            f"{'/'.join(f'{r:.2f}' for r in fdoa_res)}"
                            f" Hz, speeds "
                            f"{'/'.join(f'{s:.0f}' for s in speeds)}"
                            f" m/s)"
                        )
                scores = np.asarray(
                    fix.candidates_power_score, np.float64
                )
                best_p = int(np.argmin(scores))
                margin_p = float(
                    np.delete(scores, best_p).min() - scores[best_p]
                )
                cal_txt = (
                    "REF-gain-calibrated" if ref_tx is not None
                    else "UNcalibrated per-station gains"
                )
                if margin_p >= 0.1:
                    pref = (
                        "primary" if best_p == 0
                        else f"candidate #{best_p + 1}"
                    )
                    power_txt = (
                        f"; received-power ranking (1/r path loss, "
                        f"{cal_txt}, advisory) prefers the {pref} "
                        f"solution (consistency {scores.min():.2f} vs "
                        f"next {scores.min() + margin_p:.2f} log-σ)"
                    )
                    if power_moved and best_p == 0:
                        power_txt += (
                            " — fix moved to the power-preferred "
                            "solution (power_disambiguation on)"
                        )
                else:
                    power_txt = (
                        f"; received-power ranking ({cal_txt}) is "
                        f"inconclusive (best margin {margin_p:.2f} "
                        f"log-σ)"
                    )
                # ---- the unified verdict ----
                runner = (
                    int(np.argsort(verdict.log_odds)[-2])
                    if k_cand > 1 else 0
                )
                contribs = ", ".join(
                    f"{k2} {float(v[verdict.best] - v[runner]):+.1f}"
                    for k2, v in verdict.components.items()
                )
                post_txt = (
                    f"; unified posterior: "
                    + ("the primary" if verdict.best == 0
                       else f"candidate #{verdict.best + 1}")
                    + f" leads by {verdict.margin_nats:.1f} nats "
                    f"({contribs}) vs the "
                    f"{cfg.ghost_threshold_nats:.1f}-nat decision "
                    f"threshold"
                    + (" — fix moved to the posterior-preferred "
                       "solution" if swap_to != 0
                       else (" — decided, already the primary"
                             if actionable.decided
                             and actionable.best == 0
                             else " — abstaining, fix unmoved"))
                )
                warnings.append(
                    f"ambiguous fix (TDOA ghost): a second solution "
                    f"{sep:.0f} m away at {second[0]:.6f},{second[1]:.6f} "
                    f"fits equally well (rms {rms2:.1f} m vs "
                    f"{fix.rms_residual_m:.1f} m) — a fourth station or "
                    f"a coverage prior disambiguates"
                    f"{prior_txt}{fdoa_txt}{power_txt}{post_txt}"
                )

        if cfg.prior is not None:
            p_lat, p_lon, p_rad = cfg.prior
            d_fix = _horiz_m(fix.lat, fix.lon, p_lat, p_lon, fix.elev)
            if d_fix > p_rad:
                warnings.append(
                    f"fix is {d_fix / 1000.0:.1f} km outside the "
                    f"coverage prior ({p_rad / 1000.0:.0f} km around "
                    f"{p_lat:.4f},{p_lon:.4f})"
                )
        return fix, w, excluded, ghost_verdict

    def process_captures(
        self, captures: Dict[str, Tuple], *,
        tail: Optional["TailIngest"] = None,
    ) -> TDOAResult:
        """Run the pipeline on in-memory blocks {station: (ref1, tgt, ref2)}.

        Blocks may be complex arrays (CPU/simulator path) or planar C
        pairs (the `.dat` ingest path).

        ``tail``: a ``pipeline.ingest.TailIngest`` session that already
        streamed (part of) this window while its files were growing —
        the correlate step then drains and finalizes the session
        instead of re-streaming from byte 0, and everything downstream
        (gates, warnings, solve, ghost/outlier analysis) runs
        unchanged. Requires every capture to be a ``HostCapture`` in
        the session's exact station order."""
        cfg = self.config
        names = [n for n in captures.keys()]
        if len(names) < 3:
            raise ValueError("need at least 3 stations for a 2D fix")
        pairs = station_pairs(len(names))

        # Overlapped-ingest mode: every station arrives as a
        # host-resident HostCapture and the correlation step streams it
        # chunk-by-chunk with transfer/compute overlap
        # (pipeline/ingest.py) instead of staging whole blocks on
        # device. Everything downstream of the correlate step — gates,
        # warnings, solve, consistency/ghost/outlier analysis — runs
        # UNCHANGED. The analyses that sample the waveform eagerly
        # (received-power ghost ranking) read strided host subsamples.
        host_mode = all(
            isinstance(captures[n], HostCapture) for n in names
        )
        if tail is not None:
            if not host_mode:
                raise ValueError(
                    "tail sessions need HostCapture captures"
                )
            if tail.names != names:
                raise ValueError(
                    f"tail session stations {tail.names} != window "
                    f"stations {names}"
                )
            if not tail.check_final_sizes(
                [captures[n].u16.shape[0] for n in names]
            ):
                raise ValueError(
                    f"tail session block-length mismatch — "
                    f"{tail.mismatch}; reprocess via the batch path"
                )
        if host_mode:
            unsupported = [
                opt for opt, on in (
                    ("mode='fm'", cfg.mode != "iq"),
                    ("lo_compensation", cfg.lo_compensation == "auto"),
                    ("solve_velocity", cfg.solve_velocity),
                    ("multi_emitter", cfg.multi_emitter > 1),
                ) if on
            ]
            if unsupported:
                raise ValueError(
                    "overlapped ingest supports the standard IQ path; "
                    f"{', '.join(unsupported)} need the whole blocks on "
                    "device — use process_files/process_captures"
                )

        # Capture-time geometry: REF1/REF2 correlation-window midpoints
        # are two *original* block lengths apart even when the analysis
        # window is truncated — the drift time base must use this, not
        # the truncated length.
        if host_mode:
            orig_block_len = min(captures[n].block_len for n in names)
        else:
            orig_block_len = min(
                int((b if isinstance(b, C) else from_complex(b)).re.shape[-1])
                for b in (captures[n][0] for n in names)
            )

        def prep(b) -> C:
            if not isinstance(b, C):
                b = from_complex(b)
            if cfg.truncate_samples is not None:
                b = C(b.re[: cfg.truncate_samples], b.im[: cfg.truncate_samples])
            return b

        def stack(idx: int) -> C:
            blocks = [prep(captures[n][idx]) for n in names]
            return C(
                jnp.stack([b.re for b in blocks]),
                jnp.stack([b.im for b in blocks]),
            )

        if host_mode:
            # Small contiguous-run subsamples stand in for the waveform
            # in the eager power analyses (mean power AND the Welch
            # spectral estimator — see HostCapture.subsample_planar).
            def stack_sub(idx: int) -> C:
                return _stack_station_subsamples(
                    [captures[n].subsample_planar(idx) for n in names]
                )

            ref1, tgt, ref2 = stack_sub(0), stack_sub(1), stack_sub(2)
        else:
            ref1, tgt, ref2 = stack(0), stack(1), stack(2)

        if cfg.lo_compensation not in ("auto", "off"):
            raise ValueError(
                f"lo_compensation must be 'auto' or 'off', got "
                f"{cfg.lo_compensation!r}"
            )
        warnings: List[str] = []
        lo_ppm = None
        if cfg.lo_compensation == "auto":
            from tdoa_tpu.ops.caf import caf_pairs
            from tdoa_tpu.ops.corr import correlate_pairs, resolve_seg
            from tdoa_tpu.solve.fdoa import station_doppler_from_pairs

            with (self.timer.stage("lo-compensate") if self.timer
                  else contextlib.nullcontext()):
                lim0 = min(int(ref1.re.shape[1]), cfg.caf_max_samples)
                probe_lag = min(cfg.max_lag, 2048)
                # The CAF probe's window is only ±probe_lag, but raw REF
                # lags = geometry + clock offsets — thousands of samples
                # on unsynchronized clocks (the reason max_lag defaults
                # to 20000). When the configured lag budget exceeds the
                # probe window, pre-align: a coarse plain correlation
                # over the FULL ±max_lag measures the raw lags, a
                # min-norm per-station solve turns them into integer
                # shifts, and each station's probe slice starts at its
                # own shift — residual probe lags are then sub-sample.
                probe_sig = C(
                    ref1.re[:, :lim0].astype(jnp.float32),
                    ref1.im[:, :lim0].astype(jnp.float32),
                )
                probe_ok = True
                if cfg.max_lag > probe_lag:
                    lim_c = min(lim0, 1 << 20)
                    coarse = correlate_pairs(
                        C(ref1.re[:, :lim_c].astype(jnp.float32),
                          ref1.im[:, :lim_c].astype(jnp.float32)),
                        jnp.asarray(pairs),
                        max_lag=cfg.max_lag,
                        seg_len=cfg.seg_len,
                        weighting=cfg.weighting,
                    )
                    raw_lag = np.asarray(coarse.delay, np.float64)
                    q_coarse = np.asarray(coarse.quality, np.float64)
                    if np.abs(raw_lag).max() + 64.0 > probe_lag:
                        if q_coarse.min() < 5.0:
                            probe_ok = False
                            warnings.append(
                                "lo-compensation skipped: raw REF lags "
                                f"(max {np.abs(raw_lag).max():.0f} "
                                f"samples) exceed the probe window "
                                f"±{probe_lag} and the coarse "
                                "clock pre-alignment found no reliable "
                                "REF peaks (min peak-to-sidelobe "
                                f"{q_coarse.min():.1f})"
                            )
                        else:
                            off = station_doppler_from_pairs(
                                pairs, raw_lag, len(names)
                            )
                            off = np.round(off - off.min()).astype(int)
                            aligned_len = lim0 - int(off.max())
                            if aligned_len < 4 * cfg.caf_seg_len:
                                probe_ok = False
                                warnings.append(
                                    "lo-compensation skipped: clock "
                                    f"offsets (max {off.max()} samples) "
                                    "leave too little aligned REF1 "
                                    f"overlap ({aligned_len} samples) "
                                    "for the CAF probe"
                                )
                            else:
                                probe_sig = C(
                                    jnp.stack([
                                        jax.lax.dynamic_slice_in_dim(
                                            ref1.re[k], int(off[k]),
                                            aligned_len,
                                        )
                                        for k in range(len(names))
                                    ]).astype(jnp.float32),
                                    jnp.stack([
                                        jax.lax.dynamic_slice_in_dim(
                                            ref1.im[k], int(off[k]),
                                            aligned_len,
                                        )
                                        for k in range(len(names))
                                    ]).astype(jnp.float32),
                                )
                if probe_ok:
                    lim_p = int(probe_sig.re.shape[1])
                    probe = caf_pairs(
                        probe_sig,
                        jnp.asarray(pairs),
                        sample_rate=cfg.sample_rate,
                        max_lag=probe_lag,
                        seg_len=cfg.caf_seg_len,
                        n_doppler=cfg.caf_n_doppler,
                    )
                    nu_ref = np.asarray(probe.doppler_hz, np.float64)
                    seg_r0, _ = resolve_seg(
                        lim_p, probe_lag, cfg.caf_seg_len, None
                    )
                    bin0 = (
                        cfg.sample_rate / seg_r0
                    ) / (cfg.caf_n_doppler - 1)
                    # Peak-to-floor gate: a station with no usable REF
                    # reception gives an arbitrary (lag, Doppler)
                    # argmax; applying it would smear EVERY station's
                    # blocks.
                    p_surf = np.asarray(probe.surface, np.float64)
                    psr = np.asarray(probe.peak_value, np.float64) / (
                        p_surf.mean(axis=(1, 2)) + 1e-30
                    )
                else:
                    psr = np.zeros(len(pairs))
                    nu_ref = np.zeros(len(pairs))
                    bin0 = np.inf
                if psr.min() >= 5.0 and np.abs(nu_ref).max() > 2.0 * bin0:
                    s_ref = station_doppler_from_pairs(
                        pairs, nu_ref, len(names)
                    )
                    # LO offset scales with the tuned carrier: the REF
                    # block measures drift·f_ref; each block derotates
                    # by drift·f_block.
                    lo_ppm = s_ref / cfg.ref_freq * 1e6
                    # LO offset scales with the tuned carrier.
                    ref1 = _derotate(
                        ref1, s_ref, cfg.sample_rate)
                    ref2 = _derotate(
                        ref2, s_ref, cfg.sample_rate)
                    tgt = _derotate(
                        tgt, lo_ppm * 1e-6 * cfg.tgt_freq,
                        cfg.sample_rate)

        timer = self.timer
        stage = timer.stage if timer is not None else (
            lambda name: contextlib.nullcontext())

        ref_geo = self._ref_geo_tdoa_samples(names, pairs)
        if host_mode and tail is not None:
            with stage("tail-finalize+clock"):
                out = tail.finalize([captures[n].u16 for n in names])
                if timer is not None:
                    timer.observe(out)
        elif host_mode:
            from tdoa_tpu.pipeline.ingest import ingest_overlapped

            bl = orig_block_len
            if cfg.truncate_samples is not None:
                bl = min(bl, cfg.truncate_samples)
            with stage("ingest+correlate+clock"):
                out = ingest_overlapped(
                    [captures[n].u16 for n in names],
                    pairs,
                    ref_geo,
                    block_len=bl,
                    block_lens=[captures[n].block_len for n in names],
                    max_lag=cfg.max_lag,
                    seg_len=cfg.seg_len,
                    weighting=cfg.weighting,
                    clock_correction=cfg.clock_correction,
                )
                if timer is not None:
                    timer.observe(out)
        else:
            with stage("correlate+clock"):
                out = process_blocks(
                    ref1,
                    tgt,
                    ref2,
                    jnp.asarray(pairs),
                    jnp.asarray(ref_geo, jnp.float32),
                    max_lag=cfg.max_lag,
                    seg_len=cfg.seg_len,
                    weighting=cfg.weighting,
                    clock_correction=cfg.clock_correction,
                    mode=cfg.mode,
                    fm_decim=cfg.fm_decim,
                    sample_rate=cfg.sample_rate,
                )
                if timer is not None:
                    timer.observe(out)
        (corrected, tgt_d, ref_d, clock, quality, peaks, corr_std,
         tgt_window, tgt_std, win_c_blocks) = out
        corrected = np.asarray(corrected, np.float64)
        tdoa_s = corrected / cfg.sample_rate
        tdoa_std_s = np.asarray(corr_std, np.float64) / cfg.sample_rate
        # REF clock-correction variance (s²): the composite σ minus the
        # TGT block's own — re-attached to any re-measured TGT σ (the
        # deramp path) so σs stay commensurate across candidate sets.
        ref_var_s2 = np.maximum(
            tdoa_std_s ** 2
            - (np.asarray(tgt_std, np.float64) / cfg.sample_rate) ** 2,
            0.0,
        )
        # REF-block midpoints sit at 0.5·L and 2.5·L of the *original*
        # block length — two full blocks apart in capture time regardless
        # of analysis-window truncation.
        ref_d = np.asarray(ref_d, np.float64)
        drift_ppm = (ref_d[:, 1] - ref_d[:, 0]) / (2 * orig_block_len) * 1e6

        if lo_ppm is not None:
            rel = ", ".join(
                f"{n} {p_:+.3f}" for n, p_ in zip(names, lo_ppm)
            )
            warnings.append(
                f"receiver LO offsets measured from the REF block and "
                f"compensated (relative ppm: {rel})"
            )
        if cfg.clock_correction and self.stations.reference_tx is None:
            warnings.append(
                f"reference transmitter position unknown (no station row "
                f"named '{cfg.ref_freq:.0f}'): clock correction cancels "
                f"clock offsets but leaves the REF transmitter's per-pair "
                f"geometric TDOA in every measurement — the fix may be "
                f"biased"
            )
        lla = self.stations.lla_array(names)
        ecef = lla_to_ecef(lla)
        q_arr = np.asarray(quality[1], np.float64)
        for k, (i, j) in enumerate(pairs):
            bl = np.linalg.norm(ecef[i] - ecef[j])
            max_tdoa = bl / SPEED_OF_LIGHT
            if abs(tdoa_s[k]) > max_tdoa * 1.05:
                warnings.append(
                    f"pair {names[i]}-{names[j]}: TDOA {tdoa_s[k]*1e6:.2f} us "
                    f"exceeds baseline limit {max_tdoa*1e6:.2f} us"
                )
            if q_arr[k] < 5.0:
                warnings.append(
                    f"pair {names[i]}-{names[j]}: weak correlation "
                    f"(peak-to-sidelobe {q_arr[k]:.1f}) — measurement "
                    f"downweighted"
                )

        # Co-channel presence check: a second emitter at comparable
        # power puts a second strong peak in every pair's correlation.
        # When all pairs lock the SAME second emitter the TDOA set is
        # cycle-consistent and the fix lands cleanly — on whichever
        # source won the peak race — so no residual or quality gate can
        # see it. The secondary peak can. The detection runs in every
        # mode (the lobe-shape detector below stands down on it); the
        # WARNING is mode-1 only — with multi_emitter > 1 the
        # association path already separates and reports the sources.
        from tdoa_tpu.solve.association import top_k_peaks

        win64 = np.asarray(tgt_window, np.float64)
        cand = top_k_peaks(win64, 2)
        second_frac = cand.value[:, 1] / np.maximum(
            cand.value[:, 0], 1e-30
        )
        strong = second_frac >= 0.6
        secondary_fired = bool(
            np.count_nonzero(strong) >= max(1, (len(pairs) + 1) // 2)
        )
        if secondary_fired and cfg.multi_emitter == 1:
            warnings.append(
                f"strong secondary correlation peaks on "
                f"{int(np.count_nonzero(strong))}/{len(pairs)} pairs "
                f"(>= 60% of the primary): a co-channel emitter or "
                f"strong multipath is present and the single-emitter "
                f"fix may belong to either source — rerun with "
                f"--multi-emitter 2 to separate them"
            )
        # In-peak multipath detector: an echo INSIDE the correlation
        # peak width merges with the direct path — no secondary peak,
        # no quality drop, and a 3-station fix absorbs the common bias
        # with near-zero residual (a Monte Carlo silent miss, seed
        # 6204). The merged lobe's shape gives it away: a clean GCC
        # peak's power centroid is stable as the measuring window
        # widens (|skew| change < 0.5 over L=20→60 on clean AND noisy
        # scenes), while a direct+echo composite drags the centroid
        # further with every widening (drift > 1.0 on 11/13 planted-
        # echo scenes). Computed on the plain windows, so it stands
        # down when motion smear explains the distortion (deramp) or a
        # resolvable second source already fired the stronger warning.
        # (IQ mode only: FM-mode audio correlation is plain-weighted and
        # oversampled — its lobes are legitimately wide and asymmetric.)
        if cfg.mode == "iq":
            lobe_drift = _lobe_centroid_drift(win64)
        else:
            lobe_drift = np.zeros(len(pairs))
        # Windows the echo-bias σ accounting reads: the REPORTED
        # measurement's. A deramp adoption below swaps in the deramped
        # windows (motion smear removed there — any residual centroid
        # drag on them is echo, not motion).
        echo_win = win64

        q = np.asarray(quality[1], np.float64)
        # Quadratic quality weighting with a hard gate: a pair whose
        # correlation peak barely clears the sidelobe floor carries no
        # usable timing — letting it vote at all can drag the solve by
        # hundreds of km (its residual is unbounded). Gate only while
        # enough healthy pairs remain to fix a position.
        w = (q / np.maximum(q.max(), 1e-9)) ** 2
        gated = w * (q >= 5.0)
        if np.count_nonzero(gated) >= min(3, len(pairs)):
            w = gated
        with stage("solve"):
            fix = solve_fix(
                lla,
                tdoa_s,
                weights=w,
                pair_idx=pairs,
                solve_z=cfg.solve_z,
                tdoa_sigma_s=tdoa_std_s,
            )
        # Consistency / outlier / ghost / prior analysis runs AFTER
        # the deramp re-solve below has settled the final TDOA set
        # (solve_velocity can replace fix/weights wholesale) — see
        # _analyze_fix.

        velocity_enu = velocity_residual_hz = fdoa_out = None
        velocity_sigma = None
        caf_info = None
        deramp_note = ""
        nu_emitter = None
        motion_detected = False  # significant Doppler seen by the CAF
        if cfg.solve_velocity:
            from tdoa_tpu.ops.caf import caf_pairs
            from tdoa_tpu.ops.corr import resolve_seg
            from tdoa_tpu.solve.fdoa import (
                solve_velocity_enu,
                station_doppler_from_pairs,
            )

            with stage("caf+deramp"):
                lim = min(int(tgt.re.shape[1]), cfg.caf_max_samples)
                caf_max_lag = min(cfg.max_lag, 2048)
                tgt_c = C(
                    tgt.re[:, :lim].astype(jnp.float32),
                    tgt.im[:, :lim].astype(jnp.float32),
                )
                caf = caf_pairs(
                    tgt_c,
                    jnp.asarray(pairs),
                    sample_rate=cfg.sample_rate,
                    max_lag=caf_max_lag,
                    seg_len=cfg.caf_seg_len,
                    n_doppler=cfg.caf_n_doppler,
                )
                nu = np.asarray(caf.doppler_hz, np.float64)
                # A pair's relative clock drift (measured from the dual
                # REF blocks) is a delay rate alpha = drift_ppm·1e-6 and
                # contributes Doppler -f_tgt·alpha that is NOT emitter
                # motion — subtract it. UNLESS LO compensation already
                # derotated the blocks: the drift Doppler is then gone
                # from the signal and adding the (still-real) timing-
                # drift term would double-correct.
                drift_nu = (
                    np.zeros_like(drift_ppm) if lo_ppm is not None
                    else cfg.tgt_freq * 1e-6 * drift_ppm
                )
                nu_emitter = nu + drift_nu
                # The CAF's Doppler grid spacing, from the segment
                # length caf_pairs ACTUALLY used (resolve_seg shrinks
                # seg_len by max_lag for the alias-free window).
                seg_r, _ = resolve_seg(lim, caf_max_lag, cfg.caf_seg_len,
                                       None)
                bin_hz = (cfg.sample_rate / seg_r) / (cfg.caf_n_doppler - 1)
                # Doppler — emitter motion OR receiver LO offset (the
                # raw nu carries both) — smears the PLAIN correlation:
                # exactly what the CAF compensates. When significant,
                # run deramp-and-correlate: solve per-station frequency
                # shifts from the raw pairwise Doppler, counter-rotate
                # each station's TGT block, and re-run the full-
                # precision plain correlator. The CAF's own delay has
                # coarse-peak ambiguity on broad narrowband peaks; the
                # deramped plain path recovers sub-0.01-sample accuracy.
                deramped = np.abs(nu).max() > 2.0 * bin_hz
                motion_detected = bool(deramped)
                if deramped:
                    s_dop = station_doppler_from_pairs(
                        pairs, nu, len(names)
                    )
                    r2 = _deramp_correlate(
                        tgt, s_dop, pairs, lim, cfg.max_lag,
                        cfg.seg_len, cfg.weighting, cfg.sample_rate,
                    )
                    corrected2 = (
                        np.asarray(r2.delay, np.float64)
                        - np.asarray(clock, np.float64)
                    )
                    q2 = np.asarray(r2.quality, np.float64)
                    w2 = (q2 / np.maximum(q2.max(), 1e-9)) ** 2
                    gated2 = w2 * (q2 >= 5.0)  # same gate as the
                    # primary solve: a noise-floor pair must not vote
                    if np.count_nonzero(gated2) >= min(3, len(pairs)):
                        w2 = gated2
                    # The deramp re-measures only the TGT block; its
                    # corrected TDOAs still carry the SAME REF clock
                    # correction, so the composite σ keeps the REF
                    # variance term — comparing a TGT-only σ against
                    # the primary's composite would bias adoption
                    # toward the deramped set and under-report the
                    # adopted ellipse.
                    std2 = np.sqrt(
                        (np.asarray(r2.delay_std, np.float64)
                         / cfg.sample_rate) ** 2
                        + ref_var_s2
                    )
                    fix2 = solve_fix(
                        lla,
                        corrected2 / cfg.sample_rate,
                        weights=w2,
                        pair_idx=pairs,
                        solve_z=cfg.solve_z,
                        tdoa_sigma_s=std2,
                    )
                    # Adopt when the deramp demonstrably SHARPENED the
                    # measurement (median per-pair σ). The residual
                    # test alone is a coin flip at 3 stations — 3 TDOAs
                    # always fit 2 unknowns with near-zero residual,
                    # smeared or not (observed: a motion-smeared plain
                    # set with 1.4-3.8-sample errors and honest
                    # 3-17-sample σs out-residualed the exact deramped
                    # set and kept a 400 m fix). The σ test is the
                    # physical one: deramping re-concentrates the
                    # correlation peak, and a failed deramp (wrong
                    # per-station Doppler solve) leaves σ large. A
                    # residual win may still adopt, but only when σ did
                    # not materially degrade (≤1.5×) — otherwise a
                    # failed deramp that wins the residual coin flip
                    # would slip through.
                    med, med2 = np.median(tdoa_std_s), np.median(std2)
                    if (med2 <= med
                            or (fix2.rms_residual_m <= fix.rms_residual_m
                                and med2 <= 1.5 * med)):
                        # Adopt the deramped measurement WHOLESALE so
                        # the reported fields stay mutually consistent
                        # (delays, qualities, sigmas, weights, fix).
                        fix = fix2
                        tgt_d = r2.delay
                        corrected = corrected2
                        tdoa_s = corrected / cfg.sample_rate
                        q = q2
                        w = w2
                        tdoa_std_s = std2
                        echo_win = np.asarray(r2.corr, np.float64)
                        deramp_note = " even after Doppler deramp"
                        warnings.append(
                            "significant differential Doppler (up to "
                            f"{np.abs(nu).max():.1f} Hz — emitter motion "
                            "and/or receiver LO offset): TDOAs re-"
                            "measured by deramp-and-correlate and the "
                            "position re-solved"
                        )
        # Lobe-shape verdict, now that motion is ruled in or out: a
        # smeared mover's plain window is EXPECTED to be distorted
        # whether or not the deramp re-solve was adopted (the σ gate
        # can reject it without making the distortion multipath), and
        # a resolvable second source already set secondary_fired (in
        # any multi_emitter mode) — otherwise a drifting centroid is
        # the only trace an in-peak echo leaves.
        multipath_flagged = None
        multipath_sigma = None
        echo_sep = None
        echo_ratio = None
        echo_env_confirmed = False
        if cfg.mode == "iq" and cfg.multipath_mitigation:
            # Honest echo-bias accounting, CONTINUOUS (not gated on the
            # warning threshold): the centroid-offset statistic maps
            # each pair's lobe contamination to a calibrated σ addend,
            # plus a scene floor once any pair confirms an echo
            # environment (dsp/multipath.py echo_bias_sigma — the
            # calibration table and the measured evidence that delay
            # RE-ESTIMATION is worse than the plain GCC-HT read live
            # there). Clean scenes stay untouched (offset < knee).
            # Runs UNCONDITIONALLY on ``echo_win`` — the reported
            # measurement's windows — because the statistic is
            # self-gating (clean lobes sit under the knee) while the
            # old motion/secondary stand-down gates silenced it on
            # exactly the scenes that needed it (round-4 calibration:
            # 2 of 3 uncovered multipath tail trials were strong
            # echoes whose 60%+ secondary peaks fired secondary_fired,
            # which then suppressed the σ accounting on the reported
            # single-emitter fix). An adopted deramp reads the
            # DERAMPED windows, where a true mover's lobes are clean
            # (offset ~0 ⇒ no inflation) and only genuine echo drag
            # survives; a non-adopted deramp reports the plain set, so
            # its plain-window drag — echo or residual motion smear —
            # belongs in the reported error budget either way. A
            # co-channel source OUTSIDE the lobe (distinct peak beyond
            # ±60 lags) leaves the centroid alone; one inside it drags
            # the reported fix exactly like an echo and is covered the
            # same way.
            from tdoa_tpu.dsp.multipath import (
                _ECHO_ENV_THRESHOLD,
                REF_ECHO_CONSISTENCY_THRESHOLD,
                echo_bias_sigma,
                lobe_centroid_offset,
                mitigate_flagged_pairs,
                ref_lobe_echo_consistency,
            )

            # Environment confirmation for the σ floor: the drift
            # statistic on the SAME windows the offset reads (equal to
            # lobe_drift unless a deramp adoption swapped the windows).
            drift_echo = (
                lobe_drift if echo_win is win64
                else _lobe_centroid_drift(echo_win)
            )
            off_echo = lobe_centroid_offset(echo_win)
            # Third, INDEPENDENT confirmation lane (round 5): dual-REF
            # lobe-shape consistency. A static station-local reflector
            # marks BOTH REF blocks' lobes the same way (~1/3 capture
            # apart) while noise jitter is independent between them —
            # this sees echo environments whose TGT statistics stay
            # inside clean ranges (the invisible-echo class; 14% of it
            # detected at zero false positives over 80 clean scenes,
            # REFECHO_PROBE.json). Premise: the reflectors are
            # station-local, so the REF channel traverses them too.
            win_cx_ref = np.asarray(win_c_blocks, np.float64)
            cx_ref = win_cx_ref[0] + 1j * win_cx_ref[1]
            s_ref = ref_lobe_echo_consistency(
                np.abs(cx_ref[0]), np.abs(cx_ref[2])
            )
            ref_echo_env = bool(
                s_ref.size
                and float(s_ref.max()) > REF_ECHO_CONSISTENCY_THRESHOLD
            )
            # Scene-level echo-environment confirmation: any lane over
            # its threshold. Drives the σ floor here AND the heavy-tail
            # contour scales below.
            echo_env_confirmed = bool(
                (drift_echo.size and float(drift_echo.max()) > 1.0)
                or (off_echo.size
                    and float(off_echo.max()) > _ECHO_ENV_THRESHOLD)
                or ref_echo_env
            )
            mp_sigma = echo_bias_sigma(
                off_echo,
                env_confirmed=bool(
                    drift_echo.size and float(drift_echo.max()) > 1.0
                ) or ref_echo_env,
            )
            if ref_echo_env:
                k_r = int(np.argmax(s_ref))
                i_r, j_r = pairs[k_r]
                warnings.append(
                    f"REF-block lobes carry a consistent echo signature "
                    f"(dual-REF centroid consistency "
                    f"{float(s_ref.max()):.2f} > "
                    f"{REF_ECHO_CONSISTENCY_THRESHOLD} on "
                    f"{names[i_r]}-{names[j_r]}): station-local "
                    f"multipath environment — echo-bias σ floor applied "
                    f"to every pair"
                )
            if np.any(mp_sigma > 0):
                multipath_sigma = mp_sigma
                # Pre-inflation noise σ: the independent part of the
                # station-correlated covariance rebuilt after
                # _analyze_fix (the echo part enters through the
                # per-station bias model there, not this diagonal).
                tdoa_noise_s = tdoa_std_s.copy()
                tdoa_std_s = np.sqrt(
                    tdoa_std_s ** 2 + (mp_sigma / cfg.sample_rate) ** 2
                )
                with stage("re-solve (echo-bias σ)"):
                    fix = solve_fix(
                        lla, tdoa_s, weights=w, pair_idx=pairs,
                        solve_z=cfg.solve_z, tdoa_sigma_s=tdoa_std_s,
                    )
        if (not motion_detected and not secondary_fired
                and np.max(lobe_drift) > 1.0):
            k_d = int(np.argmax(lobe_drift))
            i_d, j_d = pairs[k_d]
            flagged = lobe_drift > 1.0
            multipath_flagged = flagged.copy()
            n_d = int(np.count_nonzero(flagged))
            # Diagnose the flagged lobes: the two-path decomposition's
            # SEPARATION and amplitude ratio are template-bias-free
            # (differences), so they reliably measure the echo's
            # geometry even though its absolute positions must not
            # replace the TDOA (dsp/multipath.py evidence table).
            fits = [None] * len(pairs)
            if cfg.multipath_mitigation:
                win_cx = np.asarray(win_c_blocks, np.float64)
                cx = win_cx[0] + 1j * win_cx[1]  # [3 (block), m, W]
                _, _, fits = mitigate_flagged_pairs(
                    cx[1], flagged, q, lobe_drift, cfg.max_lag,
                    ref_win_c=cx[[0, 2]],
                )
            detail = []
            for k in np.flatnonzero(flagged):
                fit = fits[k]
                if fit is None or not fit.decisive:
                    continue
                if echo_sep is None:
                    echo_sep = np.full(len(pairs), np.nan)
                    echo_ratio = np.full(len(pairs), np.nan)
                echo_sep[k] = fit.separation
                echo_ratio[k] = fit.echo_ratio
                excess_km = (fit.separation / cfg.sample_rate
                             * SPEED_OF_LIGHT / 1000.0)
                detail.append(
                    f"{names[pairs[k][0]]}-{names[pairs[k][1]]}: echo "
                    f"{fit.separation:.1f} samples (~{excess_km:.1f} km "
                    f"excess path) at {fit.echo_ratio:.2f} relative "
                    f"amplitude"
                )
            sigma_note = (
                "the error budget carries the calibrated echo-bias σ "
                "(multipath_sigma_samples) and the position was "
                "re-solved with it"
                if multipath_sigma is not None
                else "enable multipath_mitigation to fold the "
                     "calibrated echo-bias σ into the error budget"
            )
            diag_note = (
                " — two-path diagnosis: " + "; ".join(detail)
                if detail else ""
            )
            warnings.append(
                f"correlation main lobe is asymmetric on "
                f"{n_d}/{len(pairs)} pairs (worst {names[i_d]}-"
                f"{names[j_d]}, centroid drift "
                f"{lobe_drift[k_d]:.1f} samples): in-peak multipath "
                f"echo (or uncompensated emitter motion — rerun with "
                f"--solve-velocity); {sigma_note}{diag_note}"
            )
        # The TDOA set is final now (plain or deramp-adopted): run the
        # consistency gate, outlier rejection, ghost/prior/power
        # analysis, and the out-of-prior warning on what will actually
        # be reported.
        fix, w, excluded_stations, ghost_verdict = self._analyze_fix(
            fix, w, tdoa_s, tdoa_std_s, names, pairs, lla, tgt, ref1,
            warnings, deramp_note=deramp_note,
            # Only Doppler the CAF deemed significant (> 2 grid bins —
            # the same adaptive gate as the deramp decision) may rank
            # ghost candidates: below it the "measured" Doppler is
            # sub-bin interpolation noise and any verdict from it would
            # be noise-driven.
            fdoa_hz=nu_emitter if motion_detected else None,
        )

        if multipath_sigma is not None and fix.cov_en is not None:
            # Fix-level echo covariance (round-4): echo biases live at
            # STATIONS, so pairs sharing one are correlated — the
            # independent per-pair model's multipath fix coverage sat
            # at 72.7% 3σ while per-pair coverage was 95-96%.
            # Apportion the calibrated per-pair σ addends to
            # per-station biases (σ_pair² ≈ τ_i² + τ_j²) and rebuild
            # the FINAL fix's covariance (post ghost swaps/exclusions,
            # final weights) with the sandwich model; every internal
            # re-solve keeps the cheap independent model — only the
            # reported ellipse changes.
            from tdoa_tpu.dsp.multipath import (
                STATION_BIAS_FIX_INFLATION,
                STATION_BIAS_FIX_INFLATION_CONFIRMED,
                station_bias_apportion,
            )
            from tdoa_tpu.solve.multilateration import (
                error_ellipse,
                fix_covariance_enu_correlated,
            )

            # One γ for every echo-engaged fix (round-5: the two tiers
            # are equal — the maha tail lives in the UNCONFIRMED class,
            # so a confirmed-only inflation could never reach it; the
            # tail is covered by conf_scales below instead).
            tau_m = (
                (STATION_BIAS_FIX_INFLATION_CONFIRMED
                 if echo_env_confirmed else STATION_BIAS_FIX_INFLATION)
                * station_bias_apportion(pairs, len(names), multipath_sigma)
                / cfg.sample_rate * SPEED_OF_LIGHT
            )
            cov_mp = fix_covariance_enu_correlated(
                lla_to_enu(lla, fix.origin_lla), pairs, fix.enu,
                tdoa_noise_s * SPEED_OF_LIGHT, tau_m, weights=w,
            )
            if np.all(np.isfinite(cov_mp)):
                from tdoa_tpu.dsp.multipath import ECHO_TAIL_CONF_SCALES

                fix = dataclasses.replace(
                    fix, cov_en=cov_mp, ellipse=error_ellipse(cov_mp),
                    # EVERY echo-engaged fix carries the calibrated
                    # heavy-tail contour scales: the kσ confidence
                    # contour is the k·s_k ellipse. A single Gaussian
                    # scale cannot calibrate both the echo-bias median
                    # and its tail, and the tail's worst rows are the
                    # UNCONFIRMED ones (TGT statistics under the env
                    # thresholds) — so the scales must not be gated on
                    # confirmation (round-5 fit, MULTIPATH_CAL_r05).
                    conf_scales=ECHO_TAIL_CONF_SCALES,
                )

        if cfg.solve_velocity:
            with stage("velocity"):
                # Velocity at the (possibly re-solved) fix, in the
                # solver's own ENU frame. Weights: the post-analysis w —
                # the deramped qualities when adopted (the smeared plain
                # correlation's qualities systematically zero the
                # highest-Doppler pairs), with any outlier station's
                # pairs zeroed.
                st_v = lla_to_enu(lla, fix.origin_lla)
                vsol = solve_velocity_enu(
                    st_v, pairs, fix.enu, nu_emitter, cfg.tgt_freq,
                    weights=w, solve_z=cfg.solve_z,
                    # σ floor: ~1/8 Doppler bin (sub-bin parabolic
                    # interpolation accuracy) — with barely more pairs
                    # than unknowns the fit residual underestimates.
                    fdoa_sigma_floor_hz=bin_hz / 8.0,
                )
                velocity_enu = vsol.vel_enu
                velocity_residual_hz = vsol.residual_hz
                velocity_sigma = vsol.sigma_enu
                fdoa_out = nu_emitter
                # Plausibility check (a warning, not a gate): an FDOA
                # set mixing two co-channel emitters (or reading a
                # ghost geometry) "fits" only with an absurd velocity.
                # Observed in the Monte Carlo sweep: a mover+interferer
                # lag collision slipped association and yielded
                # 1347 m/s ± 559 — fast beyond any aircraft and with a
                # σ larger than real speeds. Flag it so a mixed-emitter
                # lock is never silent.
                spd = float(np.linalg.norm(velocity_enu))
                sig_h = float(np.linalg.norm(velocity_sigma[:2]))
                if spd > cfg.max_emitter_speed_mps or (
                    sig_h > cfg.max_emitter_speed_mps / 2.0
                ):
                    warnings.append(
                        f"velocity estimate implausible "
                        f"({spd:.0f} m/s, 1σ {sig_h:.0f} m/s vs the "
                        f"{cfg.max_emitter_speed_mps:.0f} m/s emitter "
                        f"ceiling): the FDOA set likely mixes "
                        f"co-channel emitters or reads a ghost "
                        f"geometry — treat the fix and velocity with "
                        f"suspicion"
                    )
                if cfg.multi_emitter > 1:
                    # Kept for joint (lag, Doppler) association; the
                    # host copy of the surface is only paid when the
                    # multi-emitter branch will actually read it.
                    caf_info = {
                        "surface": np.asarray(caf.surface, np.float64),
                        "max_lag": caf_max_lag,
                        "span_hz": cfg.sample_rate / (2.0 * seg_r),
                        "bin_hz": bin_hz,
                        "lim": lim,
                    }

        emitters: Optional[List[EmitterFix]] = None
        if cfg.multi_emitter > 1:
            from tdoa_tpu.solve.association import (
                associate_emitters,
                associate_emitters_joint,
                top_k_peaks,
                top_k_peaks_2d,
            )
            from tdoa_tpu.solve.fdoa import solve_velocity_enu

            k = cfg.multi_emitter + 2  # slack for sidelobes/noise peaks
            with stage("associate+solve-emitters"):
                per_fdoa: List[Optional[np.ndarray]] = []
                # The CAF surface spans only ±min(max_lag, 2048) lags.
                # Raw TGT lags = geometry (≤ baseline/c) + clock
                # offsets, which can reach thousands of samples on
                # unsynchronized clocks — the reason max_lag defaults
                # to 20000. Joint association is only valid when the
                # window provably contains them.
                joint_ok = False
                if caf_info is not None:
                    ecef_st = lla_to_ecef(lla)
                    bl_max = max(
                        np.linalg.norm(ecef_st[i] - ecef_st[j])
                        for i, j in pairs
                    )
                    bound = (
                        bl_max / SPEED_OF_LIGHT * cfg.sample_rate
                        + np.abs(np.asarray(clock, np.float64)).max()
                        + 64.0
                    )
                    joint_ok = bound < caf_info["max_lag"]
                    if not joint_ok:
                        warnings.append(
                            "raw TGT lags may exceed the CAF window "
                            f"(bound {bound:.0f} vs ±{caf_info['max_lag']}"
                            " samples): multi-emitter association fell "
                            "back to the lag-only path (no per-emitter "
                            "Doppler)"
                        )
                drift_nu_me = (
                    np.zeros_like(drift_ppm) if lo_ppm is not None
                    else cfg.tgt_freq * 1e-6 * drift_ppm
                )
                if joint_ok:
                    # Joint (lag, Doppler) association on the CAF
                    # surface: a mover whose Doppler decorrelates the
                    # plain full-block sum (anything beyond ~1/T_block)
                    # is invisible in the plain window but is a clean
                    # peak here, and every emitter gets its OWN FDOA
                    # set. Lags are parabolic-only (~0.1 sample) and
                    # windowed to the CAF's ±max_lag.
                    from tdoa_tpu.solve.association import (
                        caf_lag_resolution,
                    )
                    from tdoa_tpu.solve.fdoa import (
                        station_doppler_from_pairs,
                    )

                    surf = caf_info["surface"]
                    lag_res = caf_lag_resolution(surf)
                    # Wider slate than the lag-only path (+4, not +2):
                    # a smeared mover colliding in LAG with a static
                    # emitter leaves a ridge whose Doppler sidelobes
                    # occupy several 2D top-k slots at one lag; with
                    # only +2 the mover's own (weaker) candidate fell
                    # off the list and association found nothing
                    # (Monte Carlo seed 11657). The joint gate's
                    # second (Doppler) axis keeps the extra noise
                    # candidates from assembling spurious sets — the
                    # lag-only path has no such axis, so its slate
                    # stays at +2.
                    lags, dops, vals = top_k_peaks_2d(
                        surf, k + 2, guard_lag=lag_res
                    )
                    clock_np = np.asarray(clock, np.float64)
                    cand_tdoa = (
                        (lags - caf_info["max_lag"]) - clock_np[:, None]
                    )
                    ndop = surf.shape[1]
                    dop_step = 2.0 * caf_info["span_hz"] / (ndop - 1)
                    cand_nu_raw = -caf_info["span_hz"] + dops * dop_step
                    cand_fdoa = cand_nu_raw + drift_nu_me[:, None]
                    # Lag tolerance at the CAF's own resolution: its
                    # envelope peak localizes only to a fraction of the
                    # main-lobe width; Doppler consistency carries the
                    # fine discrimination between hypotheses.
                    joint = associate_emitters_joint(
                        cand_tdoa,
                        cand_fdoa,
                        vals,
                        pairs,
                        len(names),
                        tol_samples=max(cfg.emitter_tol_samples,
                                        0.5 * lag_res),
                        tol_hz=max(4.0, 2.0 * caf_info["bin_hz"]),
                        max_emitters=cfg.multi_emitter,
                    )
                    sets = [es for es, _ in joint]
                    per_fdoa = [f for _, f in joint]
                    # Each pair's true dominant peak (σ scaling below).
                    dominant = vals[:, 0]
                    # Per-emitter deramp refinement: counter-rotate the
                    # stations by THIS emitter's Doppler solution and
                    # re-correlate — its peak sharpens to full
                    # sub-sample precision; take the peak nearest the
                    # coarse lag (the other emitters' peaks, now
                    # smeared, sit elsewhere).
                    refined_sets = []
                    for es, e_f in zip(sets, per_fdoa):
                        nu_raw_e = e_f - drift_nu_me
                        s_e = station_doppler_from_pairs(
                            pairs, nu_raw_e, len(names)
                        )
                        re_ = _deramp_correlate(
                            tgt, s_e, pairs, caf_info["lim"],
                            caf_info["max_lag"], cfg.seg_len,
                            cfg.weighting, cfg.sample_rate,
                        )
                        win_e = np.asarray(re_.corr, np.float64)
                        raw_coarse = es.tdoa + clock_np
                        refined = np.array(es.tdoa, copy=True)
                        for pk in range(len(pairs)):
                            c0 = int(round(raw_coarse[pk])) + caf_info["max_lag"]
                            lo = max(1, c0 - lag_res)
                            hi = min(win_e.shape[1] - 1, c0 + lag_res + 1)
                            if hi <= lo:
                                continue
                            seg = win_e[pk, lo:hi]
                            i0 = int(np.argmax(seg)) + lo
                            ym1, y0, yp1 = win_e[pk, i0 - 1:i0 + 2]
                            den = ym1 - 2 * y0 + yp1
                            off = (0.5 * (ym1 - yp1) / den
                                   if abs(den) > 1e-12 else 0.0)
                            off = float(np.clip(off, -0.5, 0.5))
                            refined[pk] = (
                                i0 + off - caf_info["max_lag"]
                                - clock_np[pk]
                            )
                        refined_sets.append(es._replace(tdoa=refined))
                    sets = refined_sets
                else:
                    # Lag-only association on the plain correlation
                    # window. The window's lag axis is in correlation
                    # units: decimated audio samples for mode="fm"
                    # (rescale), IQ samples otherwise — mirrors
                    # process_blocks' max_lag_c.
                    if cfg.mode == "fm":
                        scale = float(cfg.fm_decim)
                        max_lag_c = max(cfg.max_lag // cfg.fm_decim + 2, 16)
                    else:
                        scale = 1.0
                        max_lag_c = cfg.max_lag
                    win = win64
                    cand = top_k_peaks(win, k=k)
                    cand_tdoa = (
                        (cand.lag - max_lag_c) * scale
                        - np.asarray(clock, np.float64)[:, None]
                    )
                    sets = associate_emitters(
                        cand_tdoa,
                        cand.value,
                        pairs,
                        len(names),
                        tol_samples=cfg.emitter_tol_samples,
                        max_emitters=cfg.multi_emitter,
                    )
                    per_fdoa = [None] * len(sets)
                    dominant = cand.value[:, 0]
                emitters = []
                for es, e_fdoa in zip(sets, per_fdoa):
                    ew = (es.value / max(es.value.max(), 1e-9)) ** 2
                    # tdoa_std_s was measured on each pair's DOMINANT
                    # peak (phase-slope refinement); an associated
                    # candidate that is a weaker peak has proportionally
                    # lower correlation SNR, and its lag comes from the
                    # coarser parabolic fit. Scale sigma by the peak
                    # ratio so a secondary emitter's ellipse is not
                    # copied from the primary's confidence.
                    ratio = dominant / np.maximum(es.value, 1e-12)
                    e_sigma = tdoa_std_s * np.maximum(ratio, 1.0)
                    efix = solve_fix(
                        lla,
                        es.tdoa / cfg.sample_rate,
                        weights=ew,
                        pair_idx=pairs,
                        solve_z=cfg.solve_z,
                        tdoa_sigma_s=e_sigma,
                    )
                    e_vel = e_vsig = None
                    if e_fdoa is not None:
                        ev = solve_velocity_enu(
                            lla_to_enu(lla, efix.origin_lla),
                            pairs, efix.enu, e_fdoa, cfg.tgt_freq,
                            weights=ew, solve_z=cfg.solve_z,
                            fdoa_sigma_floor_hz=caf_info["bin_hz"] / 8.0,
                        )
                        e_vel = ev.vel_enu
                        e_vsig = ev.sigma_enu
                    emitters.append(
                        EmitterFix(
                            fix=efix,
                            tdoa_samples=es.tdoa,
                            peak_value=es.value,
                            max_inconsistency_samples=es.max_inconsistency,
                            fdoa_hz=e_fdoa,
                            velocity_enu=e_vel,
                            velocity_sigma_enu=e_vsig,
                            solve_weights=np.asarray(ew, np.float64),
                        )
                    )
            if len(emitters) > 1:
                warnings.append(
                    f"{len(emitters)} co-channel emitters resolved; the "
                    f"primary fix reflects the per-pair dominant peaks "
                    f"(see emitters[] for the separated fixes)"
                )
            elif not emitters:
                # Association was requested and found NOTHING cycle-
                # consistent: the per-pair candidate peaks disagree in
                # lag (or Doppler, on the joint path). That is itself
                # a diagnosis — the capture's peaks do not belong to
                # one set of per-station arrivals — and it must never
                # pass silently, because the primary fix may then be a
                # lock on one emitter of several, or a mixture.
                warnings.append(
                    "multi-emitter association found no cycle-"
                    "consistent candidate sets (per-pair peaks "
                    "disagree in lag/Doppler): the primary fix may "
                    "mix co-channel emitters or lock onto just one "
                    "of them"
                )
        return TDOAResult(
            fix=fix,
            station_names=names,
            pair_idx=pairs,
            tgt_delay_samples=np.asarray(tgt_d, np.float64),
            ref_delay_samples=ref_d,
            clock_offset_samples=np.asarray(clock, np.float64),
            corrected_tdoa_samples=corrected,
            tdoa_seconds=tdoa_s,
            quality=q,
            peak_value=np.asarray(peaks[1], np.float64),
            tdoa_std_s=tdoa_std_s,
            clock_drift_ppm=drift_ppm,
            warnings=warnings,
            emitters=emitters,
            velocity_enu=velocity_enu,
            velocity_residual_hz=velocity_residual_hz,
            velocity_sigma_enu=velocity_sigma,
            fdoa_hz=fdoa_out,
            excluded_stations=excluded_stations or None,
            solve_weights=np.asarray(w, np.float64),
            multipath_flagged=multipath_flagged,
            multipath_sigma_samples=multipath_sigma,
            multipath_echo_separation_samples=echo_sep,
            multipath_echo_ratio=echo_ratio,
            ghost=ghost_verdict,
        )

    def process_files(self, dat_paths: Sequence[str]) -> TDOAResult:
        """Load ``.dat`` files (station identity from filenames,
        processor.go:110-122) and process them."""
        return self.process_captures(self.load_files(dat_paths))

    def tail_session(
        self, station_names: Sequence[str], block_len: int,
        chunk_samples: Optional[int] = None,
    ):
        """Create a ``pipeline.ingest.TailIngest`` session for a
        growing capture window over these stations — pair basis,
        REF-transmitter geometry, and correlator settings all taken
        from this processor, so ``process_captures(..., tail=session)``
        is numerically the processor's own host-mode path. The station
        order is normalized (sorted) to match the stream service's
        window grouping; build the captures dict in ``session.names``
        order at finalize time."""
        from tdoa_tpu.pipeline.ingest import TailIngest

        cfg = self.config
        names = sorted(station_names)
        pairs = station_pairs(len(names))
        bl = int(block_len)
        if cfg.truncate_samples is not None:
            bl = min(bl, cfg.truncate_samples)
        return TailIngest(
            names,
            pairs,
            self._ref_geo_tdoa_samples(names, pairs),
            block_len=bl,
            capture_block_len=int(block_len),
            max_lag=cfg.max_lag,
            seg_len=cfg.seg_len,
            weighting=cfg.weighting,
            clock_correction=cfg.clock_correction,
            chunk_samples=chunk_samples,
        )

    def process_files_overlapped(
        self, dat_paths: Sequence[str]
    ) -> TDOAResult:
        """Like process_files, but the captures stay HOST-resident and
        stream to the device chunk-by-chunk with transfer/compute
        overlap (pipeline/ingest.py): capture→fix costs
        ≈ max(transfer, compute) instead of their sum. Files are
        mmap'ed read-only — peak host memory is O(chunk), not
        O(capture). Standard IQ path only (fm/LO-compensation/velocity/
        multi-emitter need whole blocks on device and raise)."""
        import os

        from tdoa_tpu.io.datfile import iq_bytes_as_u16

        stage = self.timer.stage if self.timer is not None else (
            lambda name: contextlib.nullcontext())
        captures: Dict[str, HostCapture] = {}
        known = self.stations.names
        with stage("mmap"):
            for path in dat_paths:
                if not os.path.exists(path):
                    raise FileNotFoundError(
                        f"capture file not found: {path}")
                st = station_from_filename(path, known)
                if st is None:
                    raise ValueError(
                        f"cannot infer station from filename: {path} "
                        f"(known stations: {', '.join(known)})"
                    )
                if st in captures:
                    raise ValueError(
                        f"two capture files resolve to station '{st}' "
                        f"(second: {path}); pass one file per station"
                    )
                raw = np.memmap(path, dtype=np.uint8, mode="r")
                if raw.size < 6:
                    raise ValueError(f"capture too short: {path}")
                captures[st] = HostCapture(
                    u16=iq_bytes_as_u16(raw[: (raw.size // 2) * 2]),
                    block_len=raw.size // 2 // 3,
                )
        return self.process_captures(captures)

    def load_files(
        self, dat_paths: Sequence[str]
    ) -> Dict[str, Tuple[C, C, C]]:
        """Load ``.dat`` files into {station: (ref1, tgt, ref2)} float32
        planar blocks."""
        import os

        stage = self.timer.stage if self.timer is not None else (
            lambda name: contextlib.nullcontext())
        captures: Dict[str, Tuple[jax.Array, jax.Array, jax.Array]] = {}
        known = self.stations.names
        with stage("load+decode"):
            for path in dat_paths:
                if not os.path.exists(path):
                    raise FileNotFoundError(f"capture file not found: {path}")
                st = station_from_filename(path, known)
                if st is None:
                    raise ValueError(
                        f"cannot infer station from filename: {path} "
                        f"(known stations: {', '.join(known)})"
                    )
                if st in captures:
                    raise ValueError(
                        f"two capture files resolve to station '{st}' "
                        f"(second: {path}); pass one file per station"
                    )
                cap: DatCapture = load_dat(path, station=st)
                captures[st] = (cap.ref1, cap.tgt, cap.ref2)
            if self.timer is not None:
                self.timer.observe([captures[st][0].re])
        return captures
