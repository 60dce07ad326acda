"""Monte Carlo robustness sweep: randomized scenes through the full
byte-contract pipeline.

Each trial randomizes what a real deployment cannot control — station
count and geometry, emitter location, clock offsets/drift, SNR, and
(in some regimes) multipath-free co-channel interference or unsynced
millisecond clocks — then runs simulate → u8 .dat bytes → processor →
fix and scores against the planted truth. Regimes:

  clean        ideal signals, µs clocks                (tight bounds)
  noisy        weak-REF impairment profile             (CRLB-scale bounds)
  wild-clocks  ±ms offsets + drift, max_lag raised     (clock correction)
  interferer   co-channel emitter at 0.6 amplitude, multi-emitter
               association resolves both (its designed purpose)
  multipath    specular echo 15-60 samples behind the direct path at
               0.3-0.6 amplitude on the TGT signal. Echoes INSIDE the
               correlation peak width (~40 samples at ~50 kHz signal
               bandwidth) merge with the direct path and bias the TDOA
               by O(1-3 samples) — estimator physics, not a defect
               (the direct-path-preferring refinement already rejects
               the worse trade); bounds reflect it
  moving       30-150 m/s emitter, random heading, µs clocks —
               --solve-velocity path: CAF Doppler + deramp-and-
               correlate TDOAs + FDOA velocity solve. Scored against
               the block-midpoint truth position AND the planted
               velocity (within 15 m/s or its own 3σ)
  moving-interferer  static co-channel interferer at 0.6 amplitude
               UNDER a 30-150 m/s mover: joint lag-Doppler association
               separates them, per-emitter CAF reads give the mover
               its own velocity
  audio-match  a known 44.1 kHz recording drives the emitter; the
               audio-pattern matched filter (random audio/rf/auto)
               produces the TDOAs under a noisy channel, random
               clocks, and crystal drift (LO offsets for rf mode)
  stream-moving  five epoch windows of a mover through the REAL
               stream_processor CLI; window 4 carries a 200-sample
               burst on one station — the tracker must coast it on the
               innovation gate and end on the true trajectory
  4station/5station  larger networks, solve over all pairs
  ghost-fdoa   100-250 m/s mover near/just outside the hull with a
               ±6 dB CROSS-BAND per-station gain error (the REF-based
               power calibration cannot remove response differences at
               the TGT frequency): the ghost posterior's power lane
               reads calibration noise and self-limits, so far-ghost
               swaps must be decided by the FDOA speed barrier
               (GHOSTCAL_57000/61000 artifacts)
  bad-station  5 stations, one with its TGT block shifted 80-300
               samples (a multipath/interference lock: clean peaks,
               wrong delays, REF clock correction honest) —
               leave-one-station-out rejection must identify and
               exclude exactly that station and the fix must recover;
               the sweep fails if the right station is named in <90%
               of trials

A trial passes when the result is ACCURATE, or when it is inaccurate
but FLAGGED (warnings: weak correlation, baseline excess, inconsistent
set) — a capture too corrupted to solve must announce itself, and the
fix's own 1σ ellipse must cover large errors in bad-GDOP geometries.
Silent failures (wrong AND unflagged AND outside 3σ) fail the sweep
outright. Prints per-regime pass rates and error percentiles; exits
nonzero if any regime's pass rate drops below its floor or any silent
failure occurs. CPU-hermetic.

Usage: python scripts/monte_carlo.py [--trials-per-regime N] [--seed S]
       [--regimes clean,noisy,...]
"""

from __future__ import annotations

import argparse
import os
import sys
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from tdoa_tpu.geo import lla_to_enu
from tdoa_tpu.io.stations import Station, StationTable
from tdoa_tpu.pipeline.processor import ProcessorConfig, TDOAProcessor
from tdoa_tpu.sim.scene import (
    NoiseProfile,
    SimScene,
    WEAK_REF_PROFILE,
    simulate_scene,
)

REF_TX = np.array([41.25703803095629, -95.95512763589404, 349.07])
BASE_LLA = np.array(
    [
        [41.18660274289527, -95.96064116595667, 355.69],
        [41.24669616513154, -96.08366304481238, 329.0],
        [41.32916620016985, -96.03513381562004, 373.18],
    ]
)
M_PER_DEG = 111_000.0


def random_network(rng: np.random.Generator, n_st: int) -> np.ndarray:
    """n_st stations: the three surveyed sites perturbed up to ~1.5 km,
    plus extras scattered over the deployment area."""
    rows = []
    for k in range(n_st):
        base = BASE_LLA[k % 3].copy()
        jitter_deg = rng.uniform(-0.015, 0.015, 2)
        if k >= 3:
            jitter_deg = rng.uniform(-0.08, 0.08, 2)
        base[0] += jitter_deg[0]
        base[1] += jitter_deg[1]
        base[2] += rng.uniform(-30, 60)
        rows.append(base)
    return np.array(rows)


def random_target(rng: np.random.Generator, lla: np.ndarray) -> np.ndarray:
    """Emitter inside/near the network hull (good GDOP region)."""
    w = rng.dirichlet(np.ones(len(lla)))
    center = (w[:, None] * lla).sum(axis=0)
    center[0] += rng.uniform(-0.02, 0.02)
    center[1] += rng.uniform(-0.02, 0.02)
    center[2] = rng.uniform(300, 420)
    return center


def run_stream_trial(seed: int) -> dict:
    """Randomized CONTINUOUS-tracking trial through the real
    stream_processor CLI: five epoch-stamped windows of a moving
    emitter land in a directory; one mid-stream window is corrupted
    (a 200-sample TGT shift on one station — a multipath/interference
    burst). The tracker must fuse the per-window FDOA velocities,
    COAST through the corrupted window on the innovation gate, and end
    within bounds of the emitter's true final position. Scored on the
    FINAL track state (position + velocity), the stream surface the
    batch regimes never exercise."""
    import contextlib
    import io as _io
    import re
    import tempfile

    from tdoa_tpu.geo import enu_to_lla
    from tdoa_tpu.io.datfile import save_dat
    from tdoa_tpu.sim.scene import simulate_scene as _simulate

    rng = np.random.default_rng(seed)
    lla = random_network(rng, 3)
    tgt0 = random_target(rng, lla)
    names = ("st0", "st1", "st2")
    speed = rng.uniform(30.0, 120.0)
    heading = rng.uniform(0.0, 2.0 * np.pi)
    vel = np.array([speed * np.cos(heading), speed * np.sin(heading), 0.0])
    offsets = rng.uniform(-20e-6, 20e-6, 3)
    n_win, dt_s = 5, 5.0
    block_len = 1 << 18
    fs = 2e6
    corrupt_win = 3  # gate needs >= 3 accepted updates first
    bad_st = int(rng.integers(0, 3))
    epoch0 = 1_700_000_000

    with tempfile.TemporaryDirectory() as td:
        csv = os.path.join(td, "stations.csv")
        with open(csv, "w") as f:
            f.write("Name,Latitude,Longitude,Elevation\n")
            f.write(f"162400000,{REF_TX[0]},{REF_TX[1]},{REF_TX[2]}\n")
            for n, row in zip(names, lla):
                f.write(f"{n},{row[0]},{row[1]},{row[2]}\n")
        inbox = os.path.join(td, "inbox")
        os.mkdir(inbox)
        for k in range(n_win):
            tgt_k = enu_to_lla(vel * (k * dt_s), tgt0)
            sc = SimScene(
                station_names=names, station_lla=lla, ref_tx_lla=REF_TX,
                tgt_tx_lla=tgt_k, block_len=block_len, seed=seed + k,
                tgt_velocity_enu=vel, clock_offsets_s=offsets,
            )
            caps, _ = _simulate(sc)
            for n in names:
                r1, tb, r2 = caps[n]
                if k == corrupt_win and n == names[bad_st]:
                    tb = np.roll(np.asarray(tb), 200)
                save_dat(
                    os.path.join(inbox, f"{n}-{epoch0 + int(k * dt_s)}.dat"),
                    r1, tb, r2,
                )
        from tdoa_tpu.cli import stream_processor as sp

        buf = _io.StringIO()
        ebuf = _io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(ebuf):
            rc = sp.main([
                "162400000", "101900000", csv, inbox,
                "--max-lag", "512", "--seg-len", "65536",
                "--solve-velocity",
            ])
        out = buf.getvalue()
        err = ebuf.getvalue()

    lines = re.findall(
        r"epoch (\d+).*?target ([-0-9.]+),([-0-9.]+)(?: ±[0-9.]+m)? "
        r"v=\(([-+0-9.]+),([-+0-9.]+)\).*?\[(\d+) updates\](.*)", out)
    coasted = any("COASTING" in ln[6] for ln in lines)
    ok_run = rc == 0 and len(lines) == n_win
    if ok_run:
        ep_last, tlat, tlon, ve, vn, n_upd, _tail = lines[-1]
        t_final = (n_win - 1) * dt_s + 1.5 * block_len / fs
        truth_final = enu_to_lla(vel * t_final, tgt0)
        fix_err = float(np.linalg.norm(lla_to_enu(
            np.array([float(tlat), float(tlon), truth_final[2]]),
            truth_final)[:2]))
        vel_err = float(np.hypot(float(ve) - vel[0], float(vn) - vel[1]))
    else:
        fix_err, vel_err = float("inf"), float("inf")
    # The corrupted window must not have been silently ABSORBED: the
    # gate must visibly coast it (the stream contract). An inaccurate
    # final track is still non-silent when the windows carried
    # warnings (same flagged-rescue rule as the batch regimes).
    accurate = (ok_run and fix_err < 300.0 and vel_err < 15.0
                and coasted)
    n_warn = err.count("WARNING:") + err.count(
        "ghost-ambiguous window fix moved")
    flagged = n_warn > 0
    return {
        "seed": seed, "tdoa_err": 0.0 if accurate else float("inf"),
        "fix_err": fix_err, "vel_err": vel_err,
        "power_pick_err": None, "ok": accurate or flagged,
        "accurate": accurate,
        "silent": not (accurate or flagged), "warnings": n_warn,
        "excluded_right": None, "maha": None, "ambiguous": False,
    }


def run_audio_trial(seed: int) -> dict:
    """Audio-pattern-matching regime: a KNOWN 44.1 kHz recording drives
    the TGT emitter; the trial records it back (WAV-free, in memory),
    matched-filters every station against it (pipeline/audio_match.py,
    mode randomized among the audio, rf, and auto domains — auto being
    the production default with validation-driven escalation), and
    scores the
    template-derived clock-corrected TDOAs and fix against truth —
    under a noisy TGT channel, random clock offsets, and crystal drift
    (whose LO-offset component the rf mode must search out)."""
    import jax
    import jax.numpy as jnp

    from tdoa_tpu.dsp.filters import resample_fft
    from tdoa_tpu.pipeline.audio_match import match_captures
    from tdoa_tpu.sim.source import bandlimited_noise

    rng = np.random.default_rng(seed)
    lla = random_network(rng, 3)
    tgt = random_target(rng, lla)
    names = ("st0", "st1", "st2")
    block_len = 1 << 17
    fs = 2e6

    n44 = int(round(block_len * 44100.0 / fs))
    audio44 = np.asarray(
        bandlimited_noise(jax.random.PRNGKey(seed % (1 << 31)),
                          n44, 10e3, 44100.0)
    )
    audio44 = 0.8 * audio44 / np.abs(audio44).max()
    n_res = int(round(n44 * fs / 44100.0))
    audio_fs = np.asarray(resample_fft(jnp.asarray(audio44), n_res))

    sc = SimScene(
        station_names=names,
        station_lla=lla,
        ref_tx_lla=REF_TX,
        tgt_tx_lla=tgt,
        block_len=block_len,
        seed=seed,
        tgt_audio=audio_fs,
        tgt_deviation_hz=50e3,
        tgt_profile=NoiseProfile(
            signal_amplitude=1.0,
            noise_amplitude=rng.uniform(0.1, 0.5),
        ),
        clock_offsets_s=rng.uniform(-50e-6, 50e-6, 3),
        clock_drifts_ppm=rng.uniform(-0.1, 0.1, 3),
    )
    caps, truth = simulate_scene(sc)
    table = StationTable(
        stations=[Station(n, *lla[k]) for k, n in enumerate(names)],
        reference_tx=Station("162400000", *REF_TX),
    )
    proc = TDOAProcessor(
        ProcessorConfig(ref_freq=162.4e6, tgt_freq=101.9e6,
                        max_lag=1024, seg_len=None),
        table,
    )
    draw = rng.random()
    mode = "audio" if draw < 1 / 3 else ("rf" if draw < 2 / 3 else "auto")
    res = match_captures(
        proc, {n: caps[n] for n in names}, audio44, 44100.0,
        mode=mode, deviation_hz=50e3,
    )

    by = {n: k for k, n in enumerate(names)}
    order = [by[n] for n in res.station_names]
    tau = truth.station_delays_samples[:, 1]
    want = np.array(
        [tau[order[j]] - tau[order[i]] for i, j in res.pair_idx]
    )
    tdoa_err = float(
        np.abs(np.asarray(res.corrected_tdoa_samples) - want).max()
    )
    fix_err = float(np.linalg.norm(
        lla_to_enu(np.array([res.fix.lat, res.fix.lon, tgt[2]]), tgt)[:2]
    ))
    maha = None
    if res.fix.cov_en is not None and np.all(np.isfinite(res.fix.cov_en)):
        e_en = lla_to_enu(
            np.array([res.fix.lat, res.fix.lon, tgt[2]]), tgt
        )[:2]
        try:
            maha = float(np.sqrt(
                e_en @ np.linalg.solve(res.fix.cov_en, e_en)
            ))
        except np.linalg.LinAlgError:
            maha = None
    warnings = list(res.warnings) + list(res.pairwise.warnings)
    atol_tdoa, atol_fix = 4.0, 2500.0
    accurate = tdoa_err < atol_tdoa and fix_err < atol_fix
    _s3 = (res.fix.conf_scales[2]
           if res.fix.conf_scales is not None else 1.0)
    covered = (res.fix.ellipse is not None
               and fix_err < 3.0 * _s3 * res.fix.ellipse[0])
    flagged = len(warnings) > 0
    return {
        "seed": seed,
        "tdoa_err": tdoa_err,
        "fix_err": fix_err,
        "vel_err": None,
        "power_pick_err": None,
        "ok": accurate or covered or flagged,
        "accurate": accurate,
        "silent": not (accurate or covered or flagged),
        "warnings": len(warnings),
        "excluded_right": None,
        "maha": maha,
        "ambiguous": any("ambiguous fix" in w for w in warnings),
    }


def run_trial(regime: str, seed: int) -> dict:
    if regime == "stream-moving":
        return run_stream_trial(seed)
    if regime == "audio-match":
        return run_audio_trial(seed)
    rng = np.random.default_rng(seed)
    n_st = {"4station": 4, "5station": 5, "bad-station": 5}.get(regime, 3)
    lla = random_network(rng, n_st)
    tgt = random_target(rng, lla)
    names = tuple(f"st{k}" for k in range(n_st))

    kw: dict = {}
    max_lag = 768
    block_len = 1 << 17
    vel_true = None
    bad = None
    atol_tdoa, atol_fix = 0.5, 200.0
    if regime == "clean":
        kw["clock_offsets_s"] = rng.uniform(-80e-6, 80e-6, n_st)
    elif regime == "noisy":
        kw["ref_profile"] = WEAK_REF_PROFILE
        kw["tgt_profile"] = NoiseProfile(
            signal_amplitude=0.5,
            noise_amplitude=rng.uniform(0.1, 0.4),
        )
        kw["clock_offsets_s"] = rng.uniform(-50e-6, 50e-6, n_st)
        atol_tdoa, atol_fix = 6.0, 2500.0
    elif regime == "wild-clocks":
        kw["clock_offsets_s"] = rng.uniform(-4e-3, 4e-3, n_st)
        kw["clock_drifts_ppm"] = rng.uniform(-0.5, 0.5, n_st)
        max_lag = 20000
        atol_tdoa, atol_fix = 0.8, 300.0
    elif regime == "interferer":
        # Separable geometry: interferer well outside the network.
        intf = tgt.copy()
        intf[0] += rng.choice([-1, 1]) * rng.uniform(0.09, 0.15)
        intf[1] += rng.choice([-1, 1]) * rng.uniform(0.09, 0.15)
        kw["interferer_lla"] = intf
        kw["interferer_amplitude"] = 0.6
        kw["clock_offsets_s"] = rng.uniform(-50e-6, 50e-6, n_st)
        atol_tdoa, atol_fix = 2.5, 800.0
    elif regime == "multipath":
        kw["tgt_profile"] = NoiseProfile(
            signal_amplitude=1.0,
            noise_amplitude=0.05,
            multipath_amplitude=rng.uniform(0.3, 0.6),
            multipath_delay_samples=rng.uniform(15, 60),
        )
        kw["clock_offsets_s"] = rng.uniform(-50e-6, 50e-6, n_st)
        atol_tdoa, atol_fix = 3.5, 600.0
    elif regime == "moving":
        speed = rng.uniform(30.0, 150.0)
        heading = rng.uniform(0.0, 2.0 * np.pi)
        vel_true = np.array(
            [speed * np.cos(heading), speed * np.sin(heading), 0.0]
        )
        kw["tgt_velocity_enu"] = vel_true
        kw["clock_offsets_s"] = rng.uniform(-20e-6, 20e-6, n_st)
        block_len = 1 << 18  # CAF Doppler resolution needs the longer block
        max_lag = 512
        atol_tdoa, atol_fix = 1.0, 300.0
    elif regime == "ghost-fdoa":
        # FDOA-must-decide ghost regime (round-5 verdict item 6: "the
        # lane that would catch a power-calibration failure is the
        # least-exercised one"). Two structural facts confine the
        # class (probed on the ghost calibration bases): true TDOA ghosts
        # are a 3-STATION phenomenon (4+ stations overdetermine the
        # set and the second intersection fails the candidate gate),
        # and at 3 stations the pair-Doppler space has rank 2 — any
        # candidate fits the measured FDOAs residual-free — so the
        # FDOA evidence is the SPEED BARRIER: a ghost intersection
        # well beyond the truth implies an unphysical fitted velocity.
        # The scene therefore: (a) plants the mover OUTSIDE the hull
        # at 6-20 km (the ghost-prone class; its second intersection
        # typically runs far down-range where the barrier fires), and
        # (b) corrupts the power lane the REALISTIC way — per-station
        # CROSS-FREQUENCY gain error (±6 dB log-uniform): the
        # REF-based power calibration measures the front end at
        # 162.4 MHz and cannot remove response differences at the TGT
        # frequency, so the 1/r power profile reads mostly calibration
        # noise and the posterior's power lane is uninformative (and
        # occasionally WRONG — which the FDOA lane must override).
        # Near-hull mover pushed 0-8 km outward: the ghost-prone class
        # whose second intersection runs far down-range (round-4
        # GHOSTCAL: far ghosts carry fdoa barriers of 10¹-10⁷ nats).
        bearing = rng.uniform(0.0, 2.0 * np.pi)
        push_m = rng.uniform(0.0, 4e3)
        tgt[0] += push_m * np.cos(bearing) / 111_320.0
        tgt[1] += (push_m * np.sin(bearing)
                   / (111_320.0 * np.cos(np.radians(tgt[0]))))
        tgt[2] = rng.uniform(400.0, 2500.0)
        speed = rng.uniform(100.0, 250.0)
        heading = rng.uniform(0.0, 2.0 * np.pi)
        vel_true = np.array(
            [speed * np.cos(heading), speed * np.sin(heading), 0.0]
        )
        kw["tgt_velocity_enu"] = vel_true
        kw["clock_offsets_s"] = rng.uniform(-20e-6, 20e-6, n_st)
        # ±6 dB cross-band response spread (log-uniform).
        kw["station_gain_tgt"] = 10.0 ** rng.uniform(-0.3, 0.3, n_st)
        block_len = 1 << 18  # CAF Doppler resolution
        max_lag = 512
        atol_tdoa, atol_fix = 1.0, 2500.0
    elif regime == "moving-interferer":
        # A static co-channel interferer UNDER a moving target: the
        # joint lag-Doppler association must separate the two emitters, hand
        # the mover its own TDOA set, and solve its velocity from the
        # per-emitter CAF reads. The hardest composite regime: motion
        # smear + mixed correlation peaks + association, randomized.
        speed = rng.uniform(30.0, 150.0)
        heading = rng.uniform(0.0, 2.0 * np.pi)
        vel_true = np.array(
            [speed * np.cos(heading), speed * np.sin(heading), 0.0]
        )
        kw["tgt_velocity_enu"] = vel_true
        intf = tgt.copy()
        intf[0] += rng.choice([-1, 1]) * rng.uniform(0.09, 0.15)
        intf[1] += rng.choice([-1, 1]) * rng.uniform(0.09, 0.15)
        kw["interferer_lla"] = intf
        kw["interferer_amplitude"] = 0.6
        kw["clock_offsets_s"] = rng.uniform(-20e-6, 20e-6, n_st)
        block_len = 1 << 18
        max_lag = 512
        atol_tdoa, atol_fix = 2.5, 800.0
    elif regime == "bad-station":
        kw["clock_offsets_s"] = rng.uniform(-100e-6, 100e-6, n_st)
        bad = int(rng.integers(0, n_st))
        bad_shift = int(rng.choice([-1, 1]) * rng.integers(80, 300))
        atol_fix = 300.0
    else:  # 4station / 5station
        kw["clock_offsets_s"] = rng.uniform(-100e-6, 100e-6, n_st)

    sc = SimScene(
        station_names=names,
        station_lla=lla,
        ref_tx_lla=REF_TX,
        tgt_tx_lla=tgt,
        block_len=block_len,
        seed=seed,
        **kw,
    )
    caps, truth = simulate_scene(sc)
    caps = {n: caps[n] for n in names}
    if bad is not None:
        import jax.numpy as jnp

        # A multipath/interference lock: the TGT block arrives late by
        # bad_shift samples with full signal quality, while the REF
        # blocks (and so the clock correction) stay honest.
        r1, tb, r2 = caps[names[bad]]
        caps[names[bad]] = (r1, jnp.roll(tb, bad_shift), r2)
    table = StationTable(
        stations=[Station(n, *lla[k]) for k, n in enumerate(names)],
        reference_tx=Station("162400000", *REF_TX),
    )
    proc = TDOAProcessor(
        ProcessorConfig(ref_freq=162.4e6, tgt_freq=101.9e6,
                        max_lag=max_lag,
                        solve_velocity=vel_true is not None,
                        multi_emitter=2 if regime in (
                            "interferer", "moving-interferer") else 1),
        table,
    )
    res = proc.process_captures(caps)

    by = {n: k for k, n in enumerate(names)}
    order = [by[n] for n in res.station_names]
    tau = truth.station_delays_samples[:, 1]
    want = np.array(
        [tau[order[j]] - tau[order[i]] for i, j in res.pair_idx]
    )
    tdoa_errs = np.abs(res.corrected_tdoa_samples - want)
    if bad is not None:
        # The corrupted station's pairs measure the planted corruption,
        # not the estimator: score timing on the healthy pairs and the
        # exclusion verdict separately.
        healthy = np.array([
            names[bad] not in (res.station_names[i], res.station_names[j])
            for i, j in res.pair_idx
        ])
        tdoa_errs = tdoa_errs[healthy]
    tdoa_err = float(tdoa_errs.max())
    excluded_right = None
    if bad is not None:
        excluded_right = res.excluded_stations == [names[bad]]

    # Truth geometry is evaluated at the TGT block's midpoint; for a
    # moving emitter, score the fix against where it actually was then.
    mid_off = np.zeros(2)
    if vel_true is not None:
        mid_off = vel_true[:2] * (1.5 * sc.block_len / sc.sample_rate)

    def err_of(fix):
        return float(np.linalg.norm(
            lla_to_enu(np.array([fix.lat, fix.lon, tgt[2]]), tgt)[:2]
            - mid_off
        ))

    fix_err = err_of(res.fix)
    # Normalized (Mahalanobis) error against the fix's own covariance:
    # if the uncertainty model is calibrated, maha² ~ chi²(2 dof)
    # (39.3% of trials within 1σ, 86.5% within 2σ, 98.9% within 3σ).
    maha = None
    err_en = None
    if res.fix.cov_en is not None and np.all(np.isfinite(res.fix.cov_en)):
        e_en = (
            lla_to_enu(
                np.array([res.fix.lat, res.fix.lon, tgt[2]]), tgt
            )[:2] - mid_off
        )
        err_en = e_en.tolist()  # for calibration tooling (fixcov diag)
        try:
            maha = float(np.sqrt(
                e_en @ np.linalg.solve(res.fix.cov_en, e_en)
            ))
        except np.linalg.LinAlgError:
            maha = None
    vel_meas = res.velocity_enu
    vel_sig = res.velocity_sigma_enu
    if regime in ("interferer", "moving-interferer") and res.emitters:
        # Association resolves both emitters; score the one the
        # framework would hand the operator for THIS target.
        errs_e = [err_of(e.fix) for e in res.emitters]
        k_e = int(np.argmin(errs_e))
        best = errs_e[k_e]
        if best < fix_err:
            # The associated emitter matched the target better than
            # the mixed single-emitter fix: its per-emitter velocity
            # (CAF read at ITS lag) is the one the operator gets.
            e = res.emitters[k_e]
            if e.velocity_enu is not None:
                vel_meas = e.velocity_enu
                vel_sig = e.velocity_sigma_enu
        fix_err = min(fix_err, best)
        if best < atol_fix:
            tdoa_err = 0.0  # the associated set carried the target

    # Ghost-ambiguous trial: record where the power ranking points.
    power_pick_err = None
    if res.fix.candidates_power_score is not None:
        kbest = int(np.argmin(res.fix.candidates_power_score))
        c = res.fix.candidates_lla[kbest]
        power_pick_err = float(np.linalg.norm(
            lla_to_enu(np.array([c[0], c[1], tgt[2]]), tgt)[:2] - mid_off
        ))

    vel_err = None
    warnings = list(res.warnings)
    vel_ok = True
    if vel_true is not None:
        # The motion notice ("deramp-and-correlate") announces the
        # designed behavior, not a degradation — it must not count as
        # the flag that excuses an inaccurate result.
        warnings = [w for w in warnings if "deramp-and-correlate" not in w]
        if vel_meas is None:
            vel_err = float("inf")
            vel_ok = False
        else:
            dv = np.asarray(vel_meas) - vel_true
            vel_err = float(np.linalg.norm(dv))
            sig = vel_sig
            vel_ok = vel_err < 15.0 or (
                sig is not None
                and bool(np.all(np.abs(dv[:2]) < 3.0 * sig[:2] + 1.0))
            )

    accurate = tdoa_err < atol_tdoa and fix_err < atol_fix and vel_ok
    # Calibrated uncertainty: a fix whose own 1σ ellipse covers the
    # error (bad GDOP from a randomly thin network) is honest, not
    # wrong.
    # Heavy-tail regimes: the calibrated 3σ contour is 3·s3 (the
    # Student-t radial scale the fix itself reports; 1 for Gaussian).
    _s3 = (res.fix.conf_scales[2]
           if res.fix.conf_scales is not None else 1.0)
    covered = (res.fix.ellipse is not None
               and fix_err < 3.0 * _s3 * res.fix.ellipse[0]
               and vel_ok)
    flagged = len(warnings) > 0
    return {
        "seed": seed,
        "tdoa_err": tdoa_err,
        "fix_err": fix_err,
        "vel_err": vel_err,
        "power_pick_err": power_pick_err,
        "ok": accurate or covered or flagged,
        "accurate": accurate,
        "silent": not (accurate or covered or flagged),
        "warnings": len(warnings),
        "excluded_right": excluded_right,
        "maha": maha,
        "err_en": err_en,
        # Calibration tooling (ghost_calibration.py, fixcov diag):
        # the full result object and the scene truth. In-process use
        # only — never serialized by main().
        "_res": res,
        "_tgt": tgt,
        "_mid_off": mid_off,
        # Ghost-flagged trials have a bimodal error (two timing-exact
        # intersections) that no covariance models; the ellipse
        # calibration study excludes them (the ambiguity warning is
        # their defense, not the ellipse).
        "ambiguous": any("ambiguous fix" in w for w in warnings),
    }


REGIMES = {
    "clean": 1.0,
    "noisy": 1.0,
    "wild-clocks": 1.0,
    "interferer": 1.0,
    "multipath": 1.0,
    "moving": 1.0,
    "moving-interferer": 1.0,
    "stream-moving": 1.0,
    "audio-match": 1.0,
    "4station": 1.0,
    "5station": 1.0,
    "bad-station": 1.0,
    # FDOA-must-decide ghosts under cross-band power-calibration error
    # (round 5): abstentions carry the ambiguity warning (flagged), so
    # honesty is preserved; the floor allows the rare undecidable draw.
    "ghost-fdoa": 0.9,
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials-per-regime", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--regimes", default=None,
                    help="comma-separated regime filter (default: all)")
    args = ap.parse_args()
    regimes = dict(REGIMES)
    if args.regimes:
        want = [r.strip() for r in args.regimes.split(",") if r.strip()]
        unknown = [r for r in want if r not in REGIMES]
        if unknown:
            ap.error(f"unknown regime(s): {', '.join(unknown)} "
                     f"(known: {', '.join(REGIMES)})")
        regimes = {r: REGIMES[r] for r in want}

    failed_total = 0
    silent_total = 0
    ghost_total = 0
    ghost_power_right = 0
    for regime, floor in regimes.items():
        results = []
        for t in range(args.trials_per_regime):
            r = run_trial(
                regime,
                args.seed + 100 * t + zlib.crc32(regime.encode()) % 97,
            )
            results.append(r)
            if r["silent"]:
                print(f"  SILENT-FAIL {regime} seed={r['seed']} "
                      f"tdoa_err={r['tdoa_err']:.3f} "
                      f"fix_err={r['fix_err']:.1f}", flush=True)
            elif not r["accurate"]:
                # A degraded trial is honest two ways: warnings fired,
                # or the reported ellipse covered the error (3 sigma) —
                # name which, so a warnings=0 line reads as calibrated
                # uncertainty rather than a miss the gates slept on.
                how = "flagged" if r["warnings"] else "covered"
                print(f"  degraded-but-{how} {regime} seed={r['seed']} "
                      f"tdoa_err={r['tdoa_err']:.3f} "
                      f"fix_err={r['fix_err']:.1f} "
                      f"warnings={r['warnings']}", flush=True)
        te = np.array([r["tdoa_err"] for r in results])
        fe = np.array([r["fix_err"] for r in results])
        ok = sum(r["ok"] for r in results)
        acc = sum(r["accurate"] for r in results)
        silent = sum(r["silent"] for r in results)
        silent_total += silent
        rate = ok / len(results)
        status = "PASS" if rate >= floor and silent == 0 else "FAIL"
        ve = np.array([r["vel_err"] for r in results
                       if r["vel_err"] is not None])
        vel_txt = (f"  vel p50/p95 {np.percentile(ve, 50):.1f}/"
                   f"{np.percentile(ve, 95):.1f} m/s"
                   if len(ve) else "")
        print(f"[{status}] {regime:12s} ok {ok}/{len(results)} "
              f"(accurate {acc}, silent {silent})  "
              f"tdoa p50/p95 {np.percentile(te, 50):.3f}/"
              f"{np.percentile(te, 95):.3f} samp  "
              f"fix p50/p95 {np.percentile(fe, 50):.1f}/"
              f"{np.percentile(fe, 95):.1f} m{vel_txt}", flush=True)
        ghosts = [r for r in results if r["power_pick_err"] is not None]
        ghost_total += len(ghosts)
        ghost_power_right += sum(
            r["power_pick_err"] < 300.0 for r in ghosts
        )
        if rate < floor or silent:
            failed_total += 1
        excl = [r for r in results if r["excluded_right"] is not None]
        if excl:
            right = sum(r["excluded_right"] for r in excl)
            rate_x = right / len(excl)
            print(f"         outlier rejection named the corrupted "
                  f"station in {right}/{len(excl)} trials", flush=True)
            if rate_x < 0.9:
                failed_total += 1
    if ghost_total:
        print(f"ghost-ambiguous fixes: {ghost_total}; received-power "
              f"ranking named the true candidate in "
              f"{ghost_power_right}/{ghost_total}", flush=True)
    sys.exit(1 if failed_total or silent_total else 0)


if __name__ == "__main__":
    main()
