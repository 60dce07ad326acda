"""Streaming correlation and multi-target tracking.

Two capabilities on top of the batch pipeline:

1. **Incremental cross-spectrum accumulation** (``CorrAccumulator``): the
   segmented correlator's accumulator exposed as explicit functional
   state. Feed capture chunks as they arrive (stream ingest, or segments
   of a capture too long to hold), checkpoint the state between chunks
   (it is O(fft_len), capture-length independent — the natural resume
   point the reference lacks entirely, SURVEY.md §5 "Checkpoint/resume:
   none"), and finalize to delays at any time. Finalizing does not
   consume the state — estimates can be emitted continuously while
   integration keeps deepening (the reference's documented-but-unbuilt
   coherent-integration plan, snr_analysis.go:83-88).

2. **Multi-target tracking** (``TargetTracker``): per-window fixes from
   continuous processing, smoothed by an alpha-beta filter in the local
   ENU frame — the "streaming multi-target" configuration of
   BASELINE.json. Position/velocity state per target; batched solves ride
   the vmapped LM solver.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tdoa_tpu.geo import network_origin, enu_to_lla, lla_to_enu
from tdoa_tpu.ops.corr import (
    CorrResult,
    _accumulate_cross_spectra,
    _finish_correlation,
    _split_half_sigma,
    _weight_factor,
    next_pow2,
)
from tdoa_tpu.ops.cplx import C
from tdoa_tpu.solve.multilateration import solve_tdoa_enu, station_pairs
from tdoa_tpu.utils.constants import SPEED_OF_LIGHT


class AccState(NamedTuple):
    """Checkpointable accumulator: everything needed to resume or
    finalize a long-running correlation."""

    cross_re: jax.Array  # [m, F]
    cross_im: jax.Array  # [m, F]
    psd: jax.Array  # [n_st, F]
    energy: jax.Array  # [n_st]
    # Scalar count of integrated *segments* (samples = n_seg·seg_len).
    # Counting segments keeps int32 honest out to ~10^14 samples; a raw
    # sample counter would wrap after ~18 minutes at 2 Msps.
    n_seg: jax.Array
    # Split-slot cross-spectra for the empirical error bar: update
    # calls rotate through slots A/B/C (the fourth slot D is
    # total − A − B − C). Contiguous groups need the total duration up
    # front — unknowable in streaming — so the slots interleave by
    # chunk instead: a jackknife over time that sees realization noise
    # and impairment residue, though not slow drift (which contiguous
    # groups would). Four slots give the batch path's 3-dof σ
    # (ops/corr.py split_k) once all hold data; with only the even/odd
    # pair populated (2-3 chunks, or a 2-slot-era checkpoint) the
    # even (A+C) vs odd (B+D) halves reproduce the K=2 estimator.
    cross_re_a: jax.Array  # [m, F]
    cross_im_a: jax.Array  # [m, F]
    n_seg_a: jax.Array  # scalar int32
    n_chunks: jax.Array  # scalar int32 (update-call slot selector)
    cross_re_b: jax.Array  # [m, F]
    cross_im_b: jax.Array  # [m, F]
    n_seg_b: jax.Array  # scalar int32
    cross_re_c: jax.Array  # [m, F]
    cross_im_c: jax.Array  # [m, F]
    n_seg_c: jax.Array  # scalar int32


def acc_init(n_st: int, n_pairs: int, fft_len: int) -> AccState:
    return AccState(
        cross_re=jnp.zeros((n_pairs, fft_len), jnp.float32),
        cross_im=jnp.zeros((n_pairs, fft_len), jnp.float32),
        psd=jnp.zeros((n_st, fft_len), jnp.float32),
        energy=jnp.zeros((n_st,), jnp.float32),
        n_seg=jnp.zeros((), jnp.int32),
        cross_re_a=jnp.zeros((n_pairs, fft_len), jnp.float32),
        cross_im_a=jnp.zeros((n_pairs, fft_len), jnp.float32),
        n_seg_a=jnp.zeros((), jnp.int32),
        n_chunks=jnp.zeros((), jnp.int32),
        cross_re_b=jnp.zeros((n_pairs, fft_len), jnp.float32),
        cross_im_b=jnp.zeros((n_pairs, fft_len), jnp.float32),
        n_seg_b=jnp.zeros((), jnp.int32),
        cross_re_c=jnp.zeros((n_pairs, fft_len), jnp.float32),
        cross_im_c=jnp.zeros((n_pairs, fft_len), jnp.float32),
        n_seg_c=jnp.zeros((), jnp.int32),
    )


@functools.partial(
    jax.jit, static_argnames=("seg_len", "fft_len", "remove_dc"),
)
def acc_update(
    state: AccState,
    chunk: C,  # [n_st, L] planar; L a multiple of seg_len
    pair_idx: jax.Array,
    seg_len: int,
    fft_len: int,
    remove_dc: bool = False,
) -> AccState:
    """Integrate one capture chunk into the accumulator. The chunk
    length must be a multiple of ``seg_len`` (checked at trace time) —
    a ragged tail would otherwise be dropped while still being counted.
    """
    if chunk.re.shape[-1] % seg_len:
        raise ValueError(
            f"chunk length {chunk.re.shape[-1]} is not a multiple of "
            f"seg_len {seg_len}; pad or split the chunk"
        )
    if remove_dc:
        # Per-chunk mean removal — the streaming equivalent of the
        # batch path's per-block DC removal (and better: it tracks
        # slow receiver DC drift chunk by chunk).
        chunk = C(
            chunk.re - jnp.mean(chunk.re, axis=-1, keepdims=True),
            chunk.im - jnp.mean(chunk.im, axis=-1, keepdims=True),
        )
    cross, psd, energy = _accumulate_cross_spectra(
        chunk, pair_idx, seg_len, fft_len
    )
    slot = state.n_chunks % 4
    sels = [(slot == k).astype(jnp.float32) for k in range(3)]
    segs = chunk.re.shape[-1] // seg_len
    return AccState(
        cross_re=state.cross_re + cross.re,
        cross_im=state.cross_im + cross.im,
        psd=state.psd + psd,
        energy=state.energy + energy,
        n_seg=state.n_seg + segs,
        cross_re_a=state.cross_re_a + sels[0] * cross.re,
        cross_im_a=state.cross_im_a + sels[0] * cross.im,
        n_seg_a=state.n_seg_a + (slot == 0) * segs,
        n_chunks=state.n_chunks + 1,
        cross_re_b=state.cross_re_b + sels[1] * cross.re,
        cross_im_b=state.cross_im_b + sels[1] * cross.im,
        n_seg_b=state.n_seg_b + (slot == 1) * segs,
        cross_re_c=state.cross_re_c + sels[2] * cross.re,
        cross_im_c=state.cross_im_c + sels[2] * cross.im,
        n_seg_c=state.n_seg_c + (slot == 2) * segs,
    )


def acc_save(path: str, state: AccState) -> None:
    """Checkpoint the accumulator to a ``.npz`` file — the durable
    resume point the reference has no equivalent of (SURVEY.md §5:
    "Checkpoint/resume: none"). The state is O(fft_len) regardless of
    how much capture has been integrated."""
    np.savez(
        path,
        cross_re=np.asarray(state.cross_re),
        cross_im=np.asarray(state.cross_im),
        psd=np.asarray(state.psd),
        energy=np.asarray(state.energy),
        n_seg=np.asarray(state.n_seg),
        cross_re_a=np.asarray(state.cross_re_a),
        cross_im_a=np.asarray(state.cross_im_a),
        n_seg_a=np.asarray(state.n_seg_a),
        n_chunks=np.asarray(state.n_chunks),
        cross_re_b=np.asarray(state.cross_re_b),
        cross_im_b=np.asarray(state.cross_im_b),
        n_seg_b=np.asarray(state.n_seg_b),
        cross_re_c=np.asarray(state.cross_re_c),
        cross_im_c=np.asarray(state.cross_im_c),
        n_seg_c=np.asarray(state.n_seg_c),
    )


def acc_load(path: str) -> AccState:
    """Resume an accumulator from ``acc_save`` output. Checkpoints
    written before the split-slot fields load with empty slots —
    finalize then reports the model σ only (no empirical floor) until
    fresh updates populate the slots. Two-slot-era checkpoints load
    their slot A (even-parity chunks) with B/C empty; slot D = total −
    A is then the odd half, so finalize's K=2 fallback (even A+C vs
    odd B+D) reproduces the exact estimator they were written under."""
    with np.load(path) as z:
        have_split = "cross_re_a" in z.files
        have_4 = "cross_re_b" in z.files
        zero_mf = jnp.zeros_like(jnp.asarray(z["cross_re"]))
        zero_s = jnp.zeros((), jnp.int32)
        return AccState(
            cross_re=jnp.asarray(z["cross_re"]),
            cross_im=jnp.asarray(z["cross_im"]),
            psd=jnp.asarray(z["psd"]),
            energy=jnp.asarray(z["energy"]),
            n_seg=jnp.asarray(z["n_seg"]),
            cross_re_a=jnp.asarray(z["cross_re_a"]) if have_split
            else zero_mf,
            cross_im_a=jnp.asarray(z["cross_im_a"]) if have_split
            else zero_mf,
            n_seg_a=jnp.asarray(z["n_seg_a"]) if have_split else zero_s,
            n_chunks=jnp.asarray(z["n_chunks"]) if have_split else zero_s,
            cross_re_b=jnp.asarray(z["cross_re_b"]) if have_4 else zero_mf,
            cross_im_b=jnp.asarray(z["cross_im_b"]) if have_4 else zero_mf,
            n_seg_b=jnp.asarray(z["n_seg_b"]) if have_4 else zero_s,
            cross_re_c=jnp.asarray(z["cross_re_c"]) if have_4 else zero_mf,
            cross_im_c=jnp.asarray(z["cross_im_c"]) if have_4 else zero_mf,
            n_seg_c=jnp.asarray(z["n_seg_c"]) if have_4 else zero_s,
        )


@functools.partial(
    jax.jit, static_argnames=("max_lag", "weighting", "fft_len")
)
def acc_finalize(
    state: AccState,
    pair_idx: jax.Array,
    max_lag: int,
    weighting: str = "ht",
    eps: float = 1e-3,
    fft_len: Optional[int] = None,
) -> CorrResult:
    """Current delay estimates from the accumulated spectra (state is
    untouched — keep integrating afterwards).

    ``delay_std`` carries a split-slot empirical floor matching the
    batch path's estimator ladder (ops/corr.py _combine_splits): once
    all FOUR interleaved slots hold comparable data (≥2 segments each —
    the batch split_k floor — and max/min slot-segment ratio ≤2) the
    four slot zoom-DFT delays give a
    3-dof σ with the truth-calibrated K=4 scale; with only the
    even/odd halves populated (2-3 updates, or a 2-slot-era
    checkpoint) the K=2 half-split σ is folded in instead; with one
    slot total (single update, or a pre-split checkpoint) the model σ
    + coarse-jitter term stands alone. All slot delays are probed with
    the FULL accumulation's debiased weights — a 1-2 segment slot has
    no coherence of its own."""
    if fft_len is None:
        fft_len = state.cross_re.shape[-1]
    cross = C(state.cross_re, state.cross_im)
    res = _finish_correlation(
        cross,
        state.psd,
        state.energy,
        pair_idx,
        max_lag,
        weighting,
        eps,
        fft_len,
        "phase",
        n_seg=state.n_seg,
    )
    if weighting == "none":
        return res
    from tdoa_tpu.ops.corr import _SPLIT_STD_SCALE, _zoom_corr_delay

    na, nb, nc = state.n_seg_a, state.n_seg_b, state.n_seg_c
    nd = state.n_seg - na - nb - nc
    coarse = jnp.round(res.delay)
    ca = C(state.cross_re_a, state.cross_im_a)
    cb = C(state.cross_re_b, state.cross_im_b)
    cc = C(state.cross_re_c, state.cross_im_c)
    cd = C(state.cross_re - ca.re - cb.re - cc.re,
           state.cross_im - ca.im - cb.im - cc.im)
    # K=4: slot spread → 3-dof σ (same formula and calibrated constant
    # as the batch quarters). Gated on every slot holding ≥2 segments
    # (the batch ladder's split_k floor — 1-segment groups' zoom probes
    # jitter ~0.5 sample even on clean signals) AND the slots being
    # balanced (≤2x segment-count spread): the scale constant assumes
    # comparable groups, and resumed 2-slot-era checkpoints start
    # lopsided.
    counts = jnp.stack([na, nb, nc, nd])
    valid4 = jnp.logical_and(
        jnp.all(counts >= 2), jnp.max(counts) <= 2 * jnp.min(counts)
    )
    valid2 = jnp.logical_and(na + nc > 0, nb + nd > 0)

    # Leave-one-out probe weights: slot k's zoom is weighted by the
    # OTHER slots' cross (full-state PSD — per-slot PSDs are not kept,
    # and the selection bias lives in the cross PHASE alignment, which
    # LOO-cross removes; see ops/corr._combine_splits). The full-state
    # factor must NOT weight the slots: its 1/(1−γ̂²) tail selects the
    # bins where even a corrupted slot's noise aligned, dragging that
    # slot's probe to the full delay and collapsing σ.
    def _loo_w(ck, nk):
        return _weight_factor(
            C(cross.re - ck.re, cross.im - ck.im), state.psd, pair_idx,
            weighting, eps, state.n_seg - nk,
        )

    def _sigma4():
        probes = []
        for s, nk in ((ca, na), (cb, nb), (cc, nc), (cd, nd)):
            w = _loo_w(s, nk)
            probes.append(
                _zoom_corr_delay(C(s.re * w, s.im * w), coarse,
                                 fft_len, max_lag)
            )
        ds = jnp.stack(probes)  # [4, m]
        var4 = jnp.sum((ds - jnp.mean(ds, axis=0)) ** 2, axis=0) / 3.0
        return jnp.float32(_SPLIT_STD_SCALE[4]) * jnp.sqrt(var4 / 4.0)

    def _sigma2():
        # K=2 fallback: even (A+C) vs odd (B+D) — exactly the
        # historical chunk-parity halves (and what a 2-slot-era
        # checkpoint resumes into). Each half weighted by the other.
        h_a = C(ca.re + cc.re, ca.im + cc.im)
        h_b = C(cb.re + cd.re, cb.im + cd.im)
        return _split_half_sigma(
            h_a, h_b,
            _loo_w(h_a, na + nc), _loo_w(h_b, nb + nd),
            coarse, fft_len, max_lag,
        )

    # lax.cond, not where: only the active ladder rung's zoom probes
    # run — finalize is called continuously while integrating, and
    # where() would pay all six probes every call.
    sigma_emp = jax.lax.cond(
        valid4, _sigma4,
        lambda: jax.lax.cond(
            valid2, _sigma2, lambda: jnp.zeros_like(res.delay)
        ),
    )
    return res._replace(
        delay_std=jnp.maximum(res.delay_std, sigma_emp)
    )


@dataclasses.dataclass
class Track:
    """Smoothed target track in the network's ENU frame: Kalman
    position blend when the windows carry calibrated covariances,
    alpha-beta otherwise."""

    pos_enu: np.ndarray  # [3]
    vel_enu: np.ndarray  # [3] m/s
    last_t: float
    n_updates: int = 1
    quality: float = 0.0
    # Innovation-gate state: EMA of accepted horizontal innovation
    # magnitudes, consecutive coasted (rejected) windows, and the
    # lifetime rejection count.
    innov_ema_m: float = 0.0
    coasts: int = 0
    n_rejected: int = 0
    # Horizontal (E,N) position covariance of the track estimate —
    # maintained only when window fixes arrive with their own
    # calibrated covariance (TargetTracker.update covs_en).
    cov_p: Optional[np.ndarray] = None  # [2, 2]

    def lla(self, origin_lla: np.ndarray) -> np.ndarray:
        return enu_to_lla(self.pos_enu, origin_lla)

    def to_jsonable(self) -> dict:
        """JSON-safe snapshot (checkpoint/resume — see
        ``TargetTracker.state_dict``)."""
        return {
            "pos_enu": [float(v) for v in self.pos_enu],
            "vel_enu": [float(v) for v in self.vel_enu],
            "last_t": float(self.last_t),
            "n_updates": int(self.n_updates),
            "quality": float(self.quality),
            "innov_ema_m": float(self.innov_ema_m),
            "coasts": int(self.coasts),
            "n_rejected": int(self.n_rejected),
            "cov_p": None if self.cov_p is None
            else [[float(v) for v in row] for row in self.cov_p],
        }

    @classmethod
    def from_jsonable(cls, d: dict) -> "Track":
        pos = np.asarray(d["pos_enu"], np.float64)
        vel = np.asarray(d["vel_enu"], np.float64)
        cov = (None if d.get("cov_p") is None
               else np.asarray(d["cov_p"], np.float64))
        # A corrupted-but-parseable state (truncated vector, NaN from a
        # poisoned run, future schema) must fail HERE, inside the
        # loader's try, not at the first window's update.
        if pos.shape != (3,) or vel.shape != (3,):
            raise ValueError(f"track state has shapes {pos.shape}/"
                             f"{vel.shape}, want (3,)/(3,)")
        if not (np.all(np.isfinite(pos)) and np.all(np.isfinite(vel))
                and np.isfinite(float(d["last_t"]))
                and np.isfinite(float(d.get("innov_ema_m", 0.0)))):
            raise ValueError("track state has non-finite fields")
        if cov is not None and (
                cov.shape != (2, 2) or not np.all(np.isfinite(cov))):
            raise ValueError("track state has invalid cov_p")
        return cls(
            pos_enu=pos,
            vel_enu=vel,
            last_t=float(d["last_t"]),
            n_updates=int(d.get("n_updates", 1)),
            quality=float(d.get("quality", 0.0)),
            innov_ema_m=float(d.get("innov_ema_m", 0.0)),
            coasts=int(d.get("coasts", 0)),
            n_rejected=int(d.get("n_rejected", 0)),
            cov_p=cov,
        )


class TargetTracker:
    """Continuous multi-target tracking from per-window TDOA sets.

    Each call to ``update`` takes one processing window's TDOAs per
    target (seconds, pair-ordered), solves all targets in one vmapped
    device call, and folds the fixes into alpha-beta tracks.
    """

    def __init__(
        self,
        station_lla: np.ndarray,
        alpha: float = 0.5,
        beta: float = 0.1,
        solve_z: bool = False,
        innovation_gate: bool = True,
        gate_floor_m: float = 500.0,
        gate_k: float = 8.0,
        max_coasts: int = 3,
        process_sigma_v: float = 15.0,  # m/s: Kalman process noise
    ):
        self.station_lla = np.asarray(station_lla, dtype=np.float64)
        self.origin = network_origin(self.station_lla)
        self.enu = jnp.asarray(
            lla_to_enu(self.station_lla, self.origin), jnp.float32
        )
        self.pairs = jnp.asarray(station_pairs(len(station_lla)))
        self.alpha = alpha
        self.beta = beta
        self.solve_z = solve_z
        # Innovation gate: an established track rejects a measurement
        # landing far outside its own innovation history — one
        # corrupted window (co-channel burst, bad association) must not
        # yank the track. Rejected windows coast on the motion model;
        # after ``max_coasts`` consecutive rejections the measurement
        # is accepted again (the target genuinely moved — re-acquire).
        # ``innovation_gate=False`` or ``max_coasts <= 0`` disables the
        # gate entirely (plain alpha-beta on every window).
        self.innovation_gate = innovation_gate
        self.gate_floor_m = gate_floor_m
        self.gate_k = gate_k
        self.max_coasts = max_coasts
        # Unmodeled-maneuver growth for the Kalman blend: the track
        # covariance inflates by (process_sigma_v·dt)² per axis each
        # window, so a long gap or a turning emitter re-opens the gain.
        self.process_sigma_v = process_sigma_v
        self.tracks: Dict[str, Track] = {}

        self._solve_batch = jax.jit(
            jax.vmap(
                lambda rd, w: solve_tdoa_enu(
                    self.enu, self.pairs, rd, weights=w, solve_z=solve_z
                )
            )
        )

    def state_dict(self) -> dict:
        """JSON-serializable snapshot of every track — the tracking
        layer's checkpoint (the stream CLI's ``--state``). The ENU
        frame is defined by the station set, so a state is only
        meaningful for the same ``station_lla`` it was saved under."""
        return {tid: tr.to_jsonable() for tid, tr in self.tracks.items()}

    def load_state_dict(self, d: dict) -> None:
        """Resume tracks saved by ``state_dict`` (replaces any current
        track with the same id)."""
        for tid, s in d.items():
            self.tracks[str(tid)] = Track.from_jsonable(s)

    def update(
        self,
        t: float,
        tdoas_s: Dict[str, np.ndarray],  # target id -> [m] seconds
        qualities: Optional[Dict[str, float]] = None,
        fdoa_hz: Optional[Dict[str, np.ndarray]] = None,  # per-pair Doppler
        carrier_hz: Optional[float] = None,
        velocity_enu: Optional[Dict[str, np.ndarray]] = None,
        weights: Optional[Dict[str, np.ndarray]] = None,  # per-pair
        positions_enu: Optional[Dict[str, np.ndarray]] = None,
        covs_en: Optional[Dict[str, np.ndarray]] = None,  # [2,2] per tid
    ) -> Dict[str, Track]:
        """``fdoa_hz`` (CAF differential Dopplers, ops/caf.py sign
        convention) upgrades the track's velocity from differentiated
        positions to an instantaneous FDOA least-squares measurement
        (solve/fdoa.py) — one window is enough to know the velocity.
        ``velocity_enu`` passes an already-solved velocity measurement
        directly (e.g. the processor's weighted per-emitter solve) and
        takes precedence over re-solving from ``fdoa_hz``.
        ``weights`` carries the processor's final per-pair solve
        weights (``TDOAResult.solve_weights``) — without them the
        tracker's own re-solve would let pairs the processor gated or
        excluded (outlier stations) vote again.
        ``positions_enu`` (per target, in THIS tracker's origin frame)
        bypasses the tracker's own re-solve for those targets: the
        processor's fix already went through the full defense ladder
        (ghost disambiguation by prior/FDOA/power, outlier exclusion) —
        a raw re-solve here can land in the ghost basin the processor
        rejected. Targets without an entry keep the re-solve path.
        ``covs_en`` (per target, horizontal 2×2 ENU covariance of the
        window fix — ``FixResult.cov_en``) upgrades the position blend
        from the fixed-α filter to a Kalman gain: the track keeps its
        own covariance, each window is weighted by how much it actually
        knows (the covariances are chi²-calibrated — see
        scripts/ellipse_calibration.py), and a weak window moves the
        track less instead of α of the way. Targets without an entry
        keep the α-β blend."""
        if not tdoas_s:
            return self.tracks
        ids = list(tdoas_s.keys())
        if positions_enu and all(
                positions_enu.get(i) is not None for i in ids):
            # Every target already carries the processor's fix (the
            # stream CLI's normal case) — skip the batched re-solve
            # entirely instead of computing and discarding it.
            pos = np.stack([
                np.asarray(positions_enu[i], np.float64) for i in ids
            ])
        else:
            rd = jnp.asarray(
                np.stack([
                    np.asarray(tdoas_s[i]) * SPEED_OF_LIGHT for i in ids
                ]),
                jnp.float32,
            )
            ones = np.ones(int(self.pairs.shape[0]))
            w_rows = jnp.asarray(
                np.stack([
                    ones if weights is None or weights.get(i) is None
                    else np.asarray(weights[i], np.float64)
                    for i in ids
                ]),
                jnp.float32,
            )
            pos, _rms = self._solve_batch(rd, w_rows)
            pos = np.asarray(pos, np.float64)
            if positions_enu:
                for k, tid in enumerate(ids):
                    if positions_enu.get(tid) is not None:
                        pos[k] = np.asarray(positions_enu[tid], np.float64)
        st_enu = np.asarray(self.enu, np.float64)
        pairs_np = np.asarray(self.pairs)
        def valid_cov(tid):
            r = covs_en.get(tid) if covs_en else None
            if r is None:
                return None
            r = np.asarray(r, np.float64)
            if r.shape != (2, 2) or not np.all(np.isfinite(r)):
                return None
            r = 0.5 * (r + r.T)
            # 2x2 PSD check: positive diagonal + non-negative det.
            if r[0, 0] <= 0 or r[1, 1] <= 0 or np.linalg.det(r) < 0:
                return None
            return r

        for k, tid in enumerate(ids):
            q = float(qualities.get(tid, 0.0)) if qualities else 0.0
            meas = pos[k]
            R = valid_cov(tid)
            v_meas = None
            if velocity_enu is not None and tid in velocity_enu:
                v_meas = np.asarray(velocity_enu[tid], np.float64)
            elif fdoa_hz is not None and tid in fdoa_hz and carrier_hz:
                from tdoa_tpu.solve.fdoa import solve_velocity_enu

                v_meas = solve_velocity_enu(
                    st_enu, pairs_np, meas, fdoa_hz[tid], carrier_hz,
                    solve_z=self.solve_z,
                ).vel_enu
            tr = self.tracks.get(tid)
            if tr is None:
                self.tracks[tid] = Track(
                    pos_enu=meas,
                    vel_enu=v_meas if v_meas is not None else np.zeros(3),
                    last_t=t,
                    quality=q,
                    cov_p=None if R is None else R.copy(),
                )
                continue
            dt = max(t - tr.last_t, 1e-6)
            pred = tr.pos_enu + tr.vel_enu * dt
            resid = meas - pred
            innov = float(np.linalg.norm(resid[:2]))
            # Covariance predict (Kalman blend only): unmodeled
            # maneuvers grow the track's uncertainty with time.
            q_proc = (self.process_sigma_v * dt) ** 2
            cov_pred = (
                None if tr.cov_p is None
                else tr.cov_p + q_proc * np.eye(2)
            )
            # The prediction's own uncertainty widens the gate: after a
            # long gap (service restart from --state, missed windows)
            # the extrapolated position is not trustworthy, and a
            # genuine window landing far from it must be ACCEPTED, not
            # rejected for max_coasts windows of stale extrapolation.
            # For ordinary window spacings the slack (3·σv·dt) sits
            # below the 500 m floor and changes nothing.
            slack = self.process_sigma_v * dt
            if cov_pred is not None:
                slack = max(slack, float(np.sqrt(max(
                    np.linalg.eigvalsh(cov_pred)[-1], 0.0))))
            gate_m = max(self.gate_floor_m,
                         self.gate_k * tr.innov_ema_m) + 3.0 * slack
            if (self.innovation_gate and self.max_coasts > 0
                    and tr.n_updates >= 3
                    and tr.coasts < self.max_coasts
                    and innov > gate_m):
                # A measurement this far outside the track's own
                # innovation history is a corrupted window, not motion:
                # coast on the model and count the miss. max_coasts
                # consecutive rejections mean the target genuinely
                # relocated — the gate then stands down and the next
                # measurement re-acquires.
                tr.pos_enu = pred
                if cov_pred is not None:
                    # Coasting keeps the grown prediction covariance so
                    # the Kalman gain re-opens after the outage.
                    tr.cov_p = cov_pred
                tr.last_t = t
                tr.coasts += 1
                tr.n_rejected += 1
                continue
            if 0 < self.max_coasts <= tr.coasts:
                # Re-acquisition: the target persistently measures
                # elsewhere, so the old state is stale — snap to the
                # measurement instead of alpha-blending toward it over
                # many windows, and restart the track's life: n_updates
                # goes back to 1 (counted since acquisition), which
                # stands the gate down for the next two windows and
                # re-seeds the innovation EMA from them. Without the
                # restart, a moving target re-acquires into a zeroed
                # EMA whose gate then rejects every genuine window — an
                # endless reject/snap limp cycle.
                tr.pos_enu = meas
                tr.vel_enu = (
                    v_meas if v_meas is not None else np.zeros(3)
                )
                tr.innov_ema_m = 0.0
                tr.n_updates = 0
                # The old covariance described the stale state; restart
                # it from the acquiring window's own uncertainty.
                tr.cov_p = None if R is None else R.copy()
            else:
                pos_corr = None  # actual position correction (Kalman)
                if cov_pred is None and R is not None:
                    # First calibrated window on a legacy track: seed
                    # the covariance so the next window runs the true
                    # Kalman blend. (This window itself still alpha-
                    # blends — there is no prior P to weigh against.)
                    tr.cov_p = R.copy()
                if cov_pred is not None and R is not None:
                    # Kalman position update in the horizontal plane:
                    # S = P + R, K = P S⁻¹ — a weak window (large R)
                    # moves the track by almost nothing, a tight one by
                    # almost the full residual, instead of a fixed α.
                    gain = cov_pred @ np.linalg.inv(cov_pred + R)
                    tr.pos_enu = pred.copy()
                    tr.pos_enu[:2] = pred[:2] + gain @ resid[:2]
                    # No calibrated vertical covariance exists; z keeps
                    # the α blend.
                    tr.pos_enu[2] = pred[2] + self.alpha * resid[2]
                    pos_corr = tr.pos_enu - pred
                    new_p = (np.eye(2) - gain) @ cov_pred
                    tr.cov_p = 0.5 * (new_p + new_p.T)
                else:
                    if cov_pred is not None:
                        # Un-calibrated window on a Kalman track: the α
                        # blend ran, keep the grown prediction
                        # covariance alive for the next window.
                        tr.cov_p = cov_pred
                    tr.pos_enu = pred + self.alpha * resid
                if v_meas is not None:
                    # Direct velocity measurement: blend instead of the
                    # beta/dt differentiation (which only corrects
                    # velocity via position residuals, windows late).
                    tr.vel_enu = (
                        (1.0 - self.alpha) * tr.vel_enu
                        + self.alpha * v_meas
                    )
                elif pos_corr is not None:
                    # Differentiated velocity must follow the position
                    # correction the gain ACTUALLY applied (legacy
                    # relation: vel-corr = β/(α·dt) × pos-corr) — a
                    # weak window that barely moved the position must
                    # not yank the velocity either.
                    tr.vel_enu = tr.vel_enu + (
                        self.beta / (self.alpha * dt)
                    ) * pos_corr
                else:
                    tr.vel_enu = tr.vel_enu + (self.beta / dt) * resid
                tr.innov_ema_m = (
                    innov if tr.n_updates < 2
                    else 0.7 * tr.innov_ema_m + 0.3 * innov
                )
            tr.coasts = 0
            tr.last_t = t
            tr.n_updates += 1
            tr.quality = q
        return self.tracks
