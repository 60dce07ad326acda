"""TDOA processor CLI — reference contract (processor.go:1047-1051):

    python -m tdoa_tpu.cli.processor <ref_freq> <target_freq> <stations.csv> \
        <dat1> <dat2> <dat3> [...]

Loads the captures, runs the batched GCC pipeline with reference-signal
clock correction, prints per-pair TDOAs and the position fix.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tdoa_tpu.cli import setup_platform


def main(argv=None) -> int:
    setup_platform()
    p = argparse.ArgumentParser(
        prog="processor",
        description="Offline TDOA processing: .dat captures -> position fix",
    )
    p.add_argument("ref_freq", type=float, help="reference frequency, Hz")
    p.add_argument("target_freq", type=float, help="target frequency, Hz")
    p.add_argument("csv", help="lat-lon-table.csv station geometry")
    p.add_argument("dat_files", nargs="+", help=".dat capture files (>= 3)")
    p.add_argument("--max-lag", type=int, default=20000,
                   help="correlation search window, samples (default 20000)")
    p.add_argument("--seg-len", type=int, default=1 << 16,
                   help="streaming segment length, samples (default "
                        "2^16)")
    p.add_argument("--weighting", default="ht",
                   choices=["ht", "ml", "phat", "scot", "none"])
    p.add_argument("--no-clock-correction", action="store_true",
                   help="skip dual-frequency reference clock removal")
    p.add_argument("--mode", default="iq", choices=["iq", "fm"],
                   help="correlate raw IQ or FM-demodulated audio")
    p.add_argument("--fm-decim", type=int, default=8,
                   help="audio decimation factor for --mode fm")
    p.add_argument("--lo-compensation", action="store_true",
                   help="probe the REF block for receiver LO offsets "
                        "(real TCXOs: ~16 Hz per 0.1 ppm at VHF smear "
                        "every correlation) and derotate all blocks "
                        "before processing")
    p.add_argument("--solve-velocity", action="store_true",
                   help="CAF over the TGT block + FDOA least squares: "
                        "emitter velocity at the fix (clock-drift "
                        "Doppler removed via the dual REF blocks)")
    p.add_argument("--prior", metavar="LAT,LON,RADIUS_KM", default=None,
                   help="coverage prior: surveillance area as center "
                        "lat,lon (deg) and radius (km). A unique "
                        "in-prior candidate resolves a ghost-ambiguous "
                        "fix outright; a fix outside the prior is "
                        "warned about")
    p.add_argument("--power-disambiguation", action="store_true",
                   help="when a 3-station fix is ghost-ambiguous and "
                        "the 1/r received-power ranking is decisive, "
                        "move the fix to the power-preferred candidate "
                        "(assumes comparable antennas; the ranking is "
                        "always reported in the warning)")
    p.add_argument("--no-fdoa-disambiguation", action="store_true",
                   help="disable the FDOA ghost disambiguator "
                        "(--solve-velocity runs: the emitter velocity "
                        "is solved at every ghost candidate; decisive "
                        "fit-residual margin or speed plausibility "
                        "moves the fix to the physical candidate)")
    p.add_argument("--max-emitter-speed", type=float, default=700.0,
                   metavar="MPS",
                   help="speed plausibility ceiling (m/s) for the FDOA "
                        "ghost ranking only — never gates the velocity "
                        "solve itself (default 700)")
    p.add_argument("--no-outlier-rejection", action="store_true",
                   help="disable leave-one-station-out outlier rejection "
                        "(>= 5-station networks: a station whose unique "
                        "exclusion restores TDOA consistency is dropped "
                        "from the fix)")
    p.add_argument("--multi-emitter", type=int, default=1, metavar="N",
                   help="separate up to N co-channel emitters by "
                        "correlation-peak cycle-consistency (default 1: off)")
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON line instead of text")
    p.add_argument("--geojson", metavar="PATH", default=None,
                   help="also write the result as a GeoJSON "
                        "FeatureCollection (stations, fix, 1σ/3σ error "
                        "ellipses, ghost candidates, emitters, course "
                        "line) — loads directly in QGIS/Google Earth/"
                        "geojson.io")
    p.add_argument("--truncate-s", type=float, default=None,
                   help="use only the first N seconds of each block")
    p.add_argument("--overlap-ingest", action="store_true",
                   help="stream the captures host->device in chunks, "
                        "overlapping the transfer with the on-device "
                        "correlation (capture->fix ~ max(transfer, "
                        "compute) instead of their sum; files are "
                        "mmap'ed, peak host memory O(chunk)). Standard "
                        "IQ path only")
    p.add_argument("--profile", action="store_true",
                   help="print per-stage timings (device-synced) to stderr")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="capture a jax.profiler device trace into DIR "
                        "(TensorBoard-loadable)")
    from tdoa_tpu.cli import parse_prior, rewrite_prior_argv

    args = p.parse_args(
        rewrite_prior_argv(sys.argv[1:] if argv is None else argv)
    )
    prior = None if args.prior is None else parse_prior(args.prior, p.error)

    from tdoa_tpu.pipeline import TDOAProcessor
    from tdoa_tpu.utils.constants import DEFAULT_SAMPLE_RATE

    trunc = (
        int(args.truncate_s * DEFAULT_SAMPLE_RATE)
        if args.truncate_s is not None
        else None
    )
    proc = TDOAProcessor.from_csv(
        args.ref_freq,
        args.target_freq,
        args.csv,
        max_lag=args.max_lag,
        seg_len=args.seg_len,
        weighting=args.weighting,
        clock_correction=not args.no_clock_correction,
        truncate_samples=trunc,
        mode=args.mode,
        fm_decim=args.fm_decim,
        multi_emitter=args.multi_emitter,
        solve_velocity=args.solve_velocity,
        lo_compensation="auto" if args.lo_compensation else "off",
        power_disambiguation=args.power_disambiguation,
        fdoa_disambiguation=not args.no_fdoa_disambiguation,
        max_emitter_speed_mps=args.max_emitter_speed,
        prior=prior,
        outlier_rejection=not args.no_outlier_rejection,
    )
    print(f"Processing {len(args.dat_files)} captures "
          f"(ref {args.ref_freq/1e6:.4f} MHz, target {args.target_freq/1e6:.4f} MHz)",
          file=sys.stderr if args.json else sys.stdout)
    import contextlib

    from tdoa_tpu.utils.profiling import StageTimer, trace

    if args.profile:
        proc.timer = StageTimer()
    tracer = trace(args.trace) if args.trace else contextlib.nullcontext()
    try:
        with tracer:
            res = (proc.process_files_overlapped(args.dat_files)
                   if args.overlap_ingest
                   else proc.process_files(args.dat_files))
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.profile:
        print("stage timings:\n" + proc.timer.report(), file=sys.stderr)

    names = res.station_names
    if args.geojson:
        import json as _json

        from tdoa_tpu.io.geojson import result_feature_collection

        ref_tx = proc.stations.reference_tx
        fc = result_feature_collection(
            res,
            proc.stations.lla_array(names),
            names,
            ref_tx_lla=None if ref_tx is None else ref_tx.lla(),
        )
        try:
            with open(args.geojson, "w") as f:
                _json.dump(fc, f)
        except OSError as e:
            # A side-output path typo must not discard the fix the
            # pipeline just spent the whole run computing.
            print(f"warning: could not write --geojson: {e}",
                  file=sys.stderr)
        else:
            print(f"GeoJSON written to {args.geojson}",
                  file=sys.stderr if args.json else sys.stdout)
    if args.json:
        import json

        fix = res.fix
        print(json.dumps({
            "fix": {"lat": fix.lat, "lon": fix.lon, "elev": fix.elev,
                    "rms_residual_m": fix.rms_residual_m,
                    "ellipse_1sigma_m": None if fix.ellipse is None else
                    {"semi_major": fix.ellipse[0],
                     "semi_minor": fix.ellipse[1],
                     "azimuth_deg": fix.ellipse[2]},
                    # Heavy-tail contour scales (confirmed echo
                    # environments): kσ contour = k·s_k ellipse.
                    "conf_contour_scales": (
                        None if fix.conf_scales is None
                        else list(fix.conf_scales))},
            "tdoa_std_us": None if res.tdoa_std_s is None else
            [s * 1e6 for s in res.tdoa_std_s],
            "stations": names,
            "pairs": [[names[i], names[j]] for i, j in res.pair_idx],
            "tdoa_us": [s * 1e6 for s in res.tdoa_seconds],
            "raw_delay_samples": list(res.tgt_delay_samples),
            "clock_offset_samples": list(res.clock_offset_samples),
            "clock_drift_ppm": None if res.clock_drift_ppm is None else list(res.clock_drift_ppm),
            "quality": list(res.quality),
            "warnings": res.warnings,
            "excluded_stations": res.excluded_stations,
            "solve_weights": None if res.solve_weights is None else
            list(res.solve_weights),
            "candidates": None if fix.candidates_lla is None else [
                {"lat": c[0], "lon": c[1], "rms_m": r,
                 "power_score": None if fix.candidates_power_score is None
                 else fix.candidates_power_score[k]}
                for k, (c, r) in enumerate(
                    zip(fix.candidates_lla, fix.candidates_rms))
            ],
            "ghost": None if res.ghost is None else res.ghost.to_json(),
            "velocity_enu_mps": None if res.velocity_enu is None else
            list(res.velocity_enu),
            "velocity_sigma_mps": None if res.velocity_sigma_enu is None
            else list(res.velocity_sigma_enu),
            "velocity_residual_hz": res.velocity_residual_hz,
            "fdoa_hz": None if res.fdoa_hz is None else list(res.fdoa_hz),
            "emitters": None if res.emitters is None else [
                {"lat": e.fix.lat, "lon": e.fix.lon,
                 "rms_residual_m": e.fix.rms_residual_m,
                 "tdoa_samples": list(e.tdoa_samples),
                 "peak_value": list(e.peak_value),
                 "max_inconsistency_samples": e.max_inconsistency_samples,
                 "fdoa_hz": None if e.fdoa_hz is None else list(e.fdoa_hz),
                 "velocity_enu_mps": None if e.velocity_enu is None
                 else list(e.velocity_enu),
                 "velocity_sigma_mps": None if e.velocity_sigma_enu is None
                 else list(e.velocity_sigma_enu)}
                for e in res.emitters
            ],
        }))
        return 0
    print("\nPer-pair measurements:")
    for k, (i, j) in enumerate(res.pair_idx):
        print(
            f"  {names[i]:>8s} - {names[j]:<8s} "
            f"raw {res.tgt_delay_samples[k]:+9.2f}  "
            f"clock {res.clock_offset_samples[k]:+9.2f}  "
            f"TDOA {res.corrected_tdoa_samples[k]:+9.3f} samples "
            f"({res.tdoa_seconds[k]*1e6:+8.3f} us"
            + (f" ± {res.tdoa_std_s[k]*1e6:.3f}"
               if res.tdoa_std_s is not None else "")
            + f")  quality {res.quality[k]:.1f}"
        )
    if res.clock_drift_ppm is not None and np.abs(res.clock_drift_ppm).max() > 0.05:
        drifts = ", ".join(
            f"{names[i]}-{names[j]} {res.clock_drift_ppm[k]:+.2f} ppm"
            for k, (i, j) in enumerate(res.pair_idx)
        )
        print(f"  clock drift (from dual REF blocks): {drifts}")
    for w in res.warnings:
        print(f"  WARNING: {w}")
    fix = res.fix
    print(f"\nPosition fix: {fix.lat:.6f}, {fix.lon:.6f}  "
          f"(elev {fix.elev:.0f} m, residual {fix.rms_residual_m:.1f} m)")
    if fix.ellipse is not None:
        maj, mnr, az = fix.ellipse
        print(f"1-sigma error ellipse: {maj:.1f} m x {mnr:.1f} m "
              f"at {az:.0f} deg E of N")
        if fix.conf_scales is not None:
            # Heavy-tailed echo environment: the 3σ contour is wider
            # than 3× the 1σ ellipse (Student-t radial calibration).
            s3 = fix.conf_scales[2]
            print(f"3-sigma contour (echo-tail calibrated): "
                  f"{3 * s3 * maj:.1f} m x {3 * s3 * mnr:.1f} m")
    if fix.candidates_lla is not None and len(fix.candidates_lla) > 1:
        print("Other candidate solutions (TDOA ghosts):")
        for k, (lla, rms) in enumerate(
                zip(fix.candidates_lla[1:], fix.candidates_rms[1:]), 1):
            ps = ""
            if fix.candidates_power_score is not None:
                ps = (f", power-consistency "
                      f"{fix.candidates_power_score[k]:.2f} log-sigma")
            print(f"  {lla[0]:.6f}, {lla[1]:.6f}  "
                  f"(residual {rms:.1f} m{ps})")
    if res.velocity_enu is not None:
        ve, vn, vu = res.velocity_enu
        import math
        speed = math.hypot(ve, vn)
        heading = math.degrees(math.atan2(ve, vn)) % 360.0
        sig = ""
        if res.velocity_sigma_enu is not None:
            se, sn, _ = res.velocity_sigma_enu
            sig = f" ± ({se:.0f} E, {sn:.0f} N) m/s 1σ"
        print(f"Emitter velocity (FDOA): {speed:.1f} m/s "
              f"heading {heading:.0f} deg "
              f"(E {ve:+.1f}, N {vn:+.1f} m/s{sig}; "
              f"Doppler residual {res.velocity_residual_hz:.2f} Hz)")
    if res.emitters is not None and len(res.emitters) > 1:
        print(f"\nSeparated co-channel emitters ({len(res.emitters)}):")
        for n_e, e in enumerate(res.emitters):
            vtxt = ""
            if e.velocity_enu is not None:
                import math as _m
                sp = _m.hypot(e.velocity_enu[0], e.velocity_enu[1])
                vtxt = f", {sp:.0f} m/s"
            print(f"  emitter {n_e + 1}: {e.fix.lat:.6f}, {e.fix.lon:.6f}  "
                  f"(residual {e.fix.rms_residual_m:.1f} m, "
                  f"consistency {e.max_inconsistency_samples:.2f} samples"
                  f"{vtxt})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
