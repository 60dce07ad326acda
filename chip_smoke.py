"""Chip smoke test: the capture→fix path on one GPU, at full size.

    python3 chip_smoke.py                 # phases 1-6 on one card
    python3 chip_smoke.py --four-cards    # the sequence-parallel path on
                                          # four cards, against one card

Phases (each prints its own lines; any failure raises and the script
exits non-zero without printing a result):

1. device    — platform, device kind, count, JAX version, the card's
               name and power limit (nvidia-smi), compile-cache dir;
2. simulate  — 3 Omaha stations (lat-lon-table.csv), 100 s at 2 Msps,
               clock offsets +12/-31/+48 µs, written through the
               simulator CLI into a temporary directory (~1.2 GB);
3. process   — the processor CLI, batch path and --overlap-ingest, each
               run twice (compile, then warm); the fix must lie within
               50 m of the planted transmitter;
4. fm        — the processor CLI in --mode fm on the same capture;
5. stream    — the stream-processor CLI over that one epoch, one-shot,
               through the tail-ingest session;
6. parity    — the device cross-spectrum accumulator against the float64
               reference (ops/reference.py) on the decoded 100 s
               blocks, and the batch path's corrected TDOAs against the
               simulator's truth.

One process, one JAX client: the CLIs run in-process through their
``main(argv)``. The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# Deployment under test (README quick start; lat-lon-table.csv).
REF_FREQ = 162_400_000.0
TGT_FREQ = 101_900_000.0
SAMPLE_RATE = 2e6
SECONDS = 100.0  # capture duration: 3 blocks of 33.3 s
CLOCK_OFFSETS_US = ("12", "-31", "48")
FIX_TOL_M = 50.0
# Parity tolerances (see CHANGES.md): f32 FFT round-off grows ~log N,
# ~1e-7·log2(65536) per bin relative, so 1e-5 leaves a wide margin at
# HIGHEST precision while TF32 (10-bit mantissa) misses it.
CROSS_REL_L2_TOL = 1e-5
TDOA_TRUTH_TOL = 0.1  # samples, clean scene


def repo_file(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def horizontal_m(lat, lon, ref_lla) -> float:
    from tdoa_tpu.geo import lla_to_enu

    e = lla_to_enu(np.array([lat, lon, ref_lla[2]]), np.asarray(ref_lla))
    return float(np.hypot(e[0], e[1]))


def phase_device(want: str = "gpu") -> dict:
    """Refuse anything but ``want``; report the device and the cache."""
    import jax

    from tdoa_tpu.utils.platform import (
        gpu_name_power_limit,
        select_platform,
        setup_compilation_cache,
    )

    plat = select_platform(want)
    cache = setup_compilation_cache(plat)
    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    _say("device", f"platform {info['platform']}, kind {info['kind']}, "
                   f"count {info['count']}, jax {jax.__version__}")
    _say("device", f"nvidia-smi: {gpu_name_power_limit()}")
    _say("device", f"compile cache: {cache}")
    return info


def phase_simulate(workdir: str, seconds: float, csv: str,
                   seed: int = 1) -> list:
    """Write the 3-station capture through the simulator CLI."""
    from tdoa_tpu.cli import simulator

    t0 = time.time()
    rc = simulator.main([
        "--csv", csv, "--duration-s", str(seconds),
        "--clock-offsets-us", *CLOCK_OFFSETS_US,
        "--seed", str(seed), "--out", workdir,
    ])
    assert rc == 0, f"simulator exited {rc}"
    dats = sorted(glob.glob(os.path.join(workdir, "sim-*.dat")))
    assert len(dats) == 3, dats
    size = sum(os.path.getsize(p) for p in dats)
    _say("simulate", f"{len(dats)} files, {size / 1e9:.3f} GB in "
                     f"{time.time() - t0:.1f} s")
    return dats


def run_processor(dats, csv, extra) -> dict:
    """One in-process processor CLI run with --json; returns its record
    plus the wall time. The StageTimer report goes to stderr."""
    from tdoa_tpu.cli import processor

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = processor.main([
            str(REF_FREQ), str(TGT_FREQ), csv, *dats, "--json", *extra,
        ])
    wall = time.time() - t0
    assert rc == 0, f"processor exited {rc}"
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    rec["wall_s"] = wall
    return rec


def phase_process(dats, csv, tgt_lla, extra=(), label="process",
                  runs: int = 2, tol_m: float = FIX_TOL_M) -> dict:
    """Run the processor CLI ``runs`` times (first compiles); assert
    the fix lies within ``tol_m`` of the planted transmitter."""
    rec = None
    for k in range(runs):
        rec = run_processor(dats, csv, ["--profile", *extra])
        fix = rec["fix"]
        err = horizontal_m(fix["lat"], fix["lon"], tgt_lla)
        _say(label, f"run {k + 1}: {rec['wall_s']:.3f} s wall, fix "
                    f"{fix['lat']:.6f},{fix['lon']:.6f} ({err:.1f} m from "
                    f"truth), peak_bytes_in_use {_peak_bytes()}")
        assert np.isfinite(err) and err <= tol_m, (
            f"{label}: fix {err:.1f} m from the planted transmitter "
            f"(limit {tol_m} m); TDOAs {rec['tdoa_us']} us, raw "
            f"{rec['raw_delay_samples']}, quality {rec['quality']}, "
            f"warnings {rec['warnings']}")
    rec["fix_err_m"] = err
    return rec


def phase_stream(workdir: str, csv: str, tgt_lla, seconds: float,
                 extra=(), tol_m: float = FIX_TOL_M) -> dict:
    """The stream-processor CLI over the one epoch, one-shot."""
    from tdoa_tpu.cli import stream_processor

    jsonl = os.path.join(workdir, "stream.jsonl")
    t0 = time.time()
    rc = stream_processor.main([
        str(REF_FREQ), str(TGT_FREQ), csv, workdir,
        "--overlap-ingest", str(seconds), "--jsonl", jsonl, *extra,
    ])
    wall = time.time() - t0
    assert rc == 0, f"stream processor exited {rc}"
    with open(jsonl) as fh:
        recs = [json.loads(l) for l in fh if l.strip()]
    assert len(recs) == 1, recs
    fix = recs[0]["fix"]
    err = horizontal_m(fix["lat"], fix["lon"], tgt_lla)
    _say("stream", f"{wall:.3f} s wall, fix {fix['lat']:.6f},"
                   f"{fix['lon']:.6f} ({err:.1f} m from truth), "
                   f"peak_bytes_in_use {_peak_bytes()}")
    assert err <= tol_m, f"stream fix {err:.1f} m from truth"
    return recs[0]


def truth_tdoa_samples(csv: str, stations, pairs, tgt_lla) -> np.ndarray:
    """Geometric TGT TDOA per named pair, samples (the clock offsets
    cancel in the corrected TDOA)."""
    from tdoa_tpu.geo import lla_to_ecef
    from tdoa_tpu.io.stations import load_station_table
    from tdoa_tpu.utils.constants import SPEED_OF_LIGHT

    table = load_station_table(csv, reference_freq=REF_FREQ)
    d = {n: np.linalg.norm(lla_to_ecef(table.lla_array([n])[0])
                           - lla_to_ecef(tgt_lla))
         for n in stations}
    return np.array([(d[b] - d[a]) / SPEED_OF_LIGHT * SAMPLE_RATE
                     for a, b in pairs])


def phase_parity(dats, csv, batch_rec, tgt_lla, max_lag: int = 20000,
                 seg_len: int = 1 << 16, blocks=(0, 1, 2)) -> dict:
    """Device accumulator vs the float64 reference on the decoded
    blocks; batch corrected TDOAs vs the simulator's truth."""
    import jax
    import jax.numpy as jnp

    from tdoa_tpu.ops import fft as mfft
    from tdoa_tpu.ops.corr import _accumulate_cross_spectra, resolve_seg
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.ops.reference import accumulate_cross_spectra, relative_l2
    from tdoa_tpu.pipeline import TDOAProcessor

    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, csv)
    caps = proc.load_files(dats)
    names = sorted(caps)
    pairs = np.array([(i, j) for i in range(3) for j in range(i + 1, 3)],
                     np.int32)
    n = int(caps[names[0]][0].re.shape[0])
    seg, fft_len = resolve_seg(n, max_lag, seg_len, None)

    def accumulate():
        # A fresh function per call: the unpinned run below must trace
        # with the patched precision.
        return jax.jit(lambda x, p: _accumulate_cross_spectra(
            x, p, seg, fft_len))

    out = {"seg_len": seg, "fft_len": fft_len, "cross_rel_l2": [],
           "psd_rel_l2": [], "cross_rel_l2_unpinned": []}
    for b in blocks:
        x = C(jnp.stack([caps[s][b].re for s in names]),
              jnp.stack([caps[s][b].im for s in names]))
        t0 = time.time()
        cross, psd, _ = accumulate()(x, jnp.asarray(pairs))
        jax.block_until_ready(cross)
        t_dev = time.time() - t0
        got = np.asarray(cross.re, np.float64) + 1j * np.asarray(
            cross.im, np.float64)
        got_psd = np.asarray(psd, np.float64)
        # Without the HIGHEST pin: the backend's default matmul
        # precision (TF32 on the GPU) — reported, not asserted.
        saved = mfft._mm_precision
        mfft._mm_precision = lambda precision: None
        try:
            cu, _, _ = accumulate()(x, jnp.asarray(pairs))
            unp = np.asarray(cu.re, np.float64) + 1j * np.asarray(
                cu.im, np.float64)
        finally:
            mfft._mm_precision = saved
        t0 = time.time()
        ref_cross, ref_psd, _ = accumulate_cross_spectra(
            (np.asarray(x.re), np.asarray(x.im)), pairs, seg, fft_len)
        t_ref = time.time() - t0
        out["cross_rel_l2"].append(relative_l2(got, ref_cross))
        out["psd_rel_l2"].append(relative_l2(got_psd, ref_psd))
        out["cross_rel_l2_unpinned"].append(relative_l2(unp, ref_cross))
        _say("parity", f"block {b}: {n // seg} segments of {seg} "
                       f"(fft {fft_len}); cross rel L2 "
                       f"{out['cross_rel_l2'][-1]:.3e} (HIGHEST), "
                       f"{out['cross_rel_l2_unpinned'][-1]:.3e} (default "
                       f"precision); psd rel L2 {out['psd_rel_l2'][-1]:.3e};"
                       f" device {t_dev:.2f} s, float64 reference "
                       f"{t_ref:.1f} s")
    assert max(out["cross_rel_l2"]) <= CROSS_REL_L2_TOL, out
    assert max(out["psd_rel_l2"]) <= CROSS_REL_L2_TOL, out

    stations = batch_rec["stations"]
    pair_names = batch_rec["pairs"]
    got_tdoa = np.asarray(batch_rec["tdoa_us"]) * 1e-6 * SAMPLE_RATE
    want = truth_tdoa_samples(csv, stations, pair_names, tgt_lla)
    out["tdoa_err_samples"] = float(np.abs(got_tdoa - want).max())
    _say("parity", f"corrected TDOAs {np.round(got_tdoa, 4).tolist()} vs "
                   f"truth {np.round(want, 4).tolist()}: max |err| "
                   f"{out['tdoa_err_samples']:.4f} samples")
    assert out["tdoa_err_samples"] <= TDOA_TRUTH_TOL, out
    return out


def phase_four_cards(seconds: float, csv: str) -> dict:
    """process_blocks_sharded on a 4-card mesh vs process_blocks on one
    card, on the same simulated 100 s scene (segment boundaries made
    identical on both paths)."""
    import jax
    import jax.numpy as jnp

    from tdoa_tpu.cli.simulator import DEFAULT_TGT_TX
    from tdoa_tpu.io.stations import load_station_table
    from tdoa_tpu.ops.corr import resolve_seg
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.parallel import make_mesh, process_blocks_sharded
    from tdoa_tpu.pipeline import TDOAProcessor
    from tdoa_tpu.pipeline.processor import process_blocks
    from tdoa_tpu.sim import SimScene, simulate_scene
    from tdoa_tpu.solve.multilateration import station_pairs

    assert len(jax.devices()) >= 4, jax.devices()
    table = load_station_table(csv, reference_freq=REF_FREQ)
    names = tuple(n for n in table.names if n.lower() != "kevo")
    block_len = int(seconds * SAMPLE_RATE / 3)
    scene = SimScene(
        station_names=names, station_lla=table.lla_array(names),
        ref_tx_lla=table.reference_tx.lla(),
        tgt_tx_lla=np.asarray(DEFAULT_TGT_TX), ref_freq=REF_FREQ,
        tgt_freq=TGT_FREQ, sample_rate=SAMPLE_RATE, block_len=block_len,
        clock_offsets_s=np.asarray(CLOCK_OFFSETS_US, float) * 1e-6, seed=1,
    )
    captures, _ = simulate_scene(scene)
    max_lag, seg = 20000, 1 << 16
    seg_r, _ = resolve_seg(block_len, max_lag, seg, None)
    use = block_len // (4 * seg_r) * (4 * seg_r)

    def planar(b):
        z = jnp.stack([captures[nm][b][:use] for nm in names])
        return C(jnp.real(z).astype(jnp.float32),
                 jnp.imag(z).astype(jnp.float32))

    blocks = [planar(b) for b in range(3)]
    del captures
    pairs = station_pairs(len(names))
    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, csv)
    ref_geo = jnp.asarray(proc._ref_geo_tdoa_samples(names, pairs),
                          jnp.float32)
    args = (*blocks, jnp.asarray(pairs), ref_geo)
    t0 = time.time()
    single = process_blocks(*args, max_lag=max_lag, seg_len=seg,
                            weighting="ht")
    c1 = np.asarray(single[0], np.float64)
    t_single = time.time() - t0
    mesh = make_mesh(4)
    t0 = time.time()
    sharded = process_blocks_sharded(*args, mesh, max_lag=max_lag,
                                     seg_len=seg, weighting="ht")
    c4 = np.asarray(sharded[0], np.float64)
    t_sharded = time.time() - t0
    dmax = float(np.abs(c4 - c1).max())
    _say("four-cards", f"{use} samples/block ({use // seg_r} segments of "
                       f"{seg_r}); corrected TDOAs one card "
                       f"{np.round(c1, 4).tolist()}, four cards "
                       f"{np.round(c4, 4).tolist()}; max |Δ| {dmax:.3e} "
                       f"samples; first-call wall {t_single:.1f} s / "
                       f"{t_sharded:.1f} s")
    for d in jax.devices()[:4]:
        st = d.memory_stats() or {}
        _say("four-cards", f"{d}: bytes_in_use "
                           f"{st.get('bytes_in_use', 0)}, peak "
                           f"{st.get('peak_bytes_in_use', 0)}")
    assert dmax < 1e-3, f"sharded vs single max |Δ| {dmax:.3e} samples"
    return {"max_abs_delta_samples": dmax}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the 4-card sequence-parallel phase")
    args = p.parse_args(argv)

    from tdoa_tpu.cli.simulator import DEFAULT_TGT_TX

    csv = repo_file("lat-lon-table.csv")
    tgt_lla = np.asarray(DEFAULT_TGT_TX, np.float64)
    info = phase_device("gpu")
    if args.four_cards:
        phase_four_cards(SECONDS, csv)
        count = 4
    else:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            dats = phase_simulate(workdir, SECONDS, csv)
            batch = phase_process(dats, csv, tgt_lla)
            phase_process(dats, csv, tgt_lla, ["--overlap-ingest"],
                          label="overlap")
            fm = run_processor(dats, csv, ["--mode", "fm", "--profile"])
            fm_err = horizontal_m(fm["fix"]["lat"], fm["fix"]["lon"],
                                   tgt_lla)
            _say("fm", f"{fm['wall_s']:.3f} s wall, fix "
                       f"{fm['fix']['lat']:.6f},{fm['fix']['lon']:.6f} "
                       f"({fm_err:.1f} m from truth), peak_bytes_in_use "
                       f"{_peak_bytes()}")
            assert np.isfinite(fm_err), fm
            phase_stream(workdir, csv, tgt_lla, SECONDS)
            phase_parity(dats, csv, batch, tgt_lla)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        count = info["count"]

    from tdoa_tpu.utils.platform import gpu_name_power_limit

    print(f"card: {gpu_name_power_limit()}")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
