"""Headline benchmark: 3-station capture → position fix on one GPU.

Two measurements, one JSON line:

1. ``corr_throughput`` (headline): the steady-state device program —
   DC removal → segmented all-pairs GCC correlation over all three
   [REF|TGT|REF] blocks → clock correction — on device-resident blocks.
2. ``detail.full_path``: the WHOLE capture→fix path from host-resident
   u8 capture bytes: host→device transfer of 3×(2·3·block_len) bytes
   (~1.2 GB for the full 100 s run), on-device u8→planar decode, the
   same correlation/clock program, device→host readback of the TDOAs,
   and the weighted Levenberg–Marquardt position solve; plus the same
   program with the bytes already on device, the transfer alone, and
   the overlapped chunked ingest (pipeline/ingest.py).

Baseline: the north-star target from BASELINE.md — a 3×100 s @ 2 Msps
capture (600 M samples) to a fix in < 1 s, i.e. 600 Msamples/s.
``vs_baseline`` = headline / 600.

Runs on a GPU. Any other backend is refused unless ``JAX_PLATFORMS=cpu``
is set explicitly — a CPU rehearsal at a tiny size, whose output names
the CPU and is no device measurement.

Environment knobs:
  BENCH_SECONDS     capture seconds to simulate (default 100).
  BENCH_SEG         segment length (default 2^16).
  BENCH_MAX_LAG     correlation window (default 20000 — the reference's).
  BENCH_FFT_PRECISION  f32 (default) | bf16 DFT-matmul operands.
  BENCH_FULL        0 skips the full-path measurement (default on).
  BENCH_STATIONS    station count (default 3). The full-path
                    measurement only runs at 3 stations — its solve
                    geometry is the Omaha deployment.
  BENCH_ARTIFACT    also write the JSON line to this path.

Prints ONE JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np
import jax
import jax.numpy as jnp

from tdoa_tpu.utils.platform import (
    gpu_name_power_limit,
    setup_compilation_cache,
)


def _platform() -> str:
    """The backend to measure on: the GPU, or the CPU only when the
    caller asked for it explicitly."""
    plat = jax.devices()[0].platform
    if plat == "gpu":
        return plat
    if plat == "cpu" and os.environ.get("JAX_PLATFORMS", "") == "cpu":
        return plat
    raise SystemExit(
        f"bench.py measures a GPU; the default backend is '{plat}'. "
        f"Set JAX_PLATFORMS=cpu for a CPU rehearsal."
    )


def main() -> None:
    t0 = time.time()
    plat = _platform()
    backend_init_s = time.time() - t0
    cache_dir = setup_compilation_cache(plat)
    cache_entries = len(os.listdir(cache_dir)) if cache_dir else 0

    seconds = float(os.environ.get("BENCH_SECONDS", "100"))
    seg_len = int(os.environ.get("BENCH_SEG", str(1 << 16)))
    max_lag = int(os.environ.get("BENCH_MAX_LAG", "20000"))
    fft_precision = os.environ.get("BENCH_FFT_PRECISION", "f32")
    fs = 2_000_000.0
    n_st = int(os.environ.get("BENCH_STATIONS", "3"))

    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.pipeline.processor import process_blocks

    # Keep blocks a multiple of seg_len so the scan covers everything.
    block_len = max(int(seconds * fs / 3) // seg_len, 1) * seg_len
    total_samples = 3 * block_len * n_st

    # Synthesize station blocks directly on device from cheap RNG — the
    # benchmark measures processing, not simulation; correlation cost is
    # data-independent.
    @jax.jit
    def make_block(k):
        kr, ki = jax.random.split(k)
        return C(
            jax.random.normal(kr, (n_st, block_len), jnp.float32),
            jax.random.normal(ki, (n_st, block_len), jnp.float32),
        )

    ref1, tgt, ref2 = (make_block(k)
                       for k in jax.random.split(jax.random.PRNGKey(0), 3))
    jax.block_until_ready((ref1, tgt, ref2))

    base_pairs = tuple(
        (i, j) for i in range(n_st) for j in range(i + 1, n_st)
    )
    pair_idx = jnp.asarray(np.array(base_pairs, np.int32))
    ref_geo = jnp.zeros(len(base_pairs), jnp.float32)

    def dispatch():
        return process_blocks(
            ref1, tgt, ref2, pair_idx, ref_geo,
            max_lag=max_lag, seg_len=seg_len, weighting="ht",
            fft_precision=fft_precision,
        )

    t0 = time.time()
    jax.block_until_ready(dispatch())  # compile + first run
    compile_s = time.time() - t0

    times = []
    for _ in range(5):
        t0 = time.time()
        jax.block_until_ready(dispatch())
        times.append(time.time() - t0)
    times.sort()
    steady_s = times[len(times) // 2]
    robust_s = times[0]

    # Sustained throughput: queue 5 program dispatches back-to-back and
    # wait once, so per-call host dispatch amortizes away — what the
    # device sustains when a capture stream keeps its queue non-empty.
    sustained = []
    for _ in range(3):
        t0 = time.time()
        outs = [dispatch() for _ in range(5)]
        jax.block_until_ready(outs)
        sustained.append((time.time() - t0) / 5)
    sustained.sort()
    sustained_s = sustained[len(sustained) // 2]

    throughput = total_samples / robust_s / 1e6  # Msamples/s/chip
    target = 600.0  # Msamples/s == 3x100s capture in 1 s

    full_detail = None
    if os.environ.get("BENCH_FULL", "1") != "0" and n_st == 3:
        full_detail = _full_path(block_len, seg_len, max_lag, fs,
                                 fft_precision, pair_idx, ref_geo,
                                 total_samples, seconds)

    dev = jax.devices()[0]
    payload = {
        "metric": "corr_throughput",
        "value": round(throughput, 2),
        "unit": "Msamples/s/chip",
        "vs_baseline": round(throughput / target, 3),
        "detail": {
            "capture_seconds": seconds,
            "stations": n_st,
            "pairs": len(base_pairs),
            "total_samples": total_samples,
            # Headline latency: min of 5 reps; the median beside it.
            "headline_latency_s": round(robust_s, 4),
            "steady_latency_s": round(steady_s, 4),
            "median_msamples_per_s": round(
                total_samples / steady_s / 1e6, 2),
            "steady_latency_min_med_max_s": [
                round(t, 4) for t in (times[0], steady_s, times[-1])
            ],
            "sustained_latency_s": round(sustained_s, 4),
            "sustained_msamples_per_s": round(
                total_samples / sustained_s / 1e6, 2),
            "backend_init_s": round(backend_init_s, 1),
            "compile_plus_first_run_s": round(compile_s, 1),
            "compilation_cache": {
                "dir": cache_dir, "entries_at_start": cache_entries,
            },
            "seg_len": seg_len,
            "max_lag": max_lag,
            "fft_precision": fft_precision,
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(jax.devices()),
                "name_power_limit": gpu_name_power_limit(),
            },
            "full_path": full_detail,
        },
    }
    line = json.dumps(payload)
    print(line)
    artifact = os.environ.get("BENCH_ARTIFACT", "")
    if artifact:
        with open(artifact, "w") as f:
            f.write(line + "\n")


def _full_path(block_len, seg_len, max_lag, fs, fft_precision, pair_idx,
               ref_geo, total_samples, seconds) -> dict:
    """Host u8 bytes → decode → correlate → solve, four ways."""
    from tdoa_tpu.io.datfile import u16_to_iq_planar
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.pipeline.ingest import ingest_overlapped
    from tdoa_tpu.pipeline.processor import process_blocks
    from tdoa_tpu.solve.multilateration import solve_fix

    n_st = 3
    # Host-resident capture bytes, one u16-packed array per station
    # (exactly what load_dat ships after its zero-copy u16 view).
    rng = np.random.default_rng(0)
    host_u16 = [
        rng.integers(0, 1 << 16, size=3 * block_len, dtype=np.uint16)
        for _ in range(n_st)
    ]

    @jax.jit
    def ingest_and_process(p0, p1, p2):
        blocks = [u16_to_iq_planar(p) for p in (p0, p1, p2)]
        n = block_len

        def blk(sl):
            return C(
                jnp.stack([b.re[sl] for b in blocks]),
                jnp.stack([b.im[sl] for b in blocks]),
            )

        return process_blocks(
            blk(slice(0, n)), blk(slice(n, 2 * n)), blk(slice(2 * n, 3 * n)),
            pair_idx, ref_geo, max_lag=max_lag, seg_len=seg_len,
            weighting="ht", fft_precision=fft_precision,
        )

    station_lla = np.array(
        [[41.18660274289527, -95.96064116595667, 355.69],
         [41.24669616513154, -96.08366304481238, 329.0],
         [41.32916620016985, -96.03513381562004, 373.18]]
    )
    pairs_np = np.array([[0, 1], [0, 2], [1, 2]])

    def solve(out):
        corrected = np.asarray(out[0], np.float64)  # sync + readback
        quality = np.asarray(out[4][1], np.float64)
        stds = np.asarray(out[6], np.float64)
        w = (quality / max(quality.max(), 1e-9)) ** 2
        return solve_fix(
            station_lla, corrected / fs, weights=w, pair_idx=pairs_np,
            tdoa_sigma_s=stds / fs,
        )

    def timed(fn):
        fn()  # compile / warm
        t0 = time.time()
        fn()
        return time.time() - t0

    full_s = timed(lambda: solve(ingest_and_process(*host_u16)))
    # Same program with the capture bytes ALREADY on device: decode +
    # correlate + clock + readback + solve without the host→device leg.
    dev_u16 = [jax.device_put(h) for h in host_u16]
    jax.block_until_ready(dev_u16)
    device_path_s = timed(lambda: solve(ingest_and_process(*dev_u16)))
    del dev_u16
    transfer_s = timed(
        lambda: jax.block_until_ready([jax.device_put(h) for h in host_u16])
    )
    host_bytes = sum(h.nbytes for h in host_u16)
    overlap_diag = {}
    overlap_s = timed(lambda: solve(ingest_overlapped(
        host_u16, pairs_np, np.zeros(3, np.float32), block_len=block_len,
        max_lag=max_lag, seg_len=seg_len, weighting="ht",
        diag=overlap_diag,
    )))
    return {
        "full_path_s": round(full_s, 4),
        "includes": "host->device transfer + u8 decode + correlate "
                    "+ clock correction + TDOA readback + LM solve",
        "device_path_s": round(device_path_s, 4),
        "host_bytes": host_bytes,
        "transfer_only_s": round(transfer_s, 4),
        "link_mb_per_s": round(host_bytes / transfer_s / 1e6, 1),
        # Chunked double-buffered ingest: should track
        # max(transfer, device compute), not their sum.
        "overlap_path_s": round(overlap_s, 4),
        "ingest_adaptive": overlap_diag,
        "overlap_vs_max_transfer_compute": round(
            overlap_s / max(transfer_s, device_path_s), 3),
        "full_path_msamples_per_s": round(total_samples / full_s / 1e6, 2),
        # The <1 s north star is defined for the 100 s capture.
        "beats_1s_target": bool(full_s < 1.0) if seconds >= 100 else None,
    }


if __name__ == "__main__":
    main()
