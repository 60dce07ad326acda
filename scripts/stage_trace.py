"""Per-stage device time of the processor on one GPU, from a profiler trace.

    python3 scripts/stage_trace.py [--out FILE.json]

Simulates the chip_smoke.py capture (3 Omaha stations, 2 Msps), runs the
processor CLI once to compile and once under ``jax.profiler`` — batch IQ
and ``--mode fm`` — and reduces each trace with
``tdoa_tpu.utils.profiling.device_stage_times`` into the device time of
the named stages: ``segment_fft_accumulate`` (segment FFT + cross-spectra
+ accumulation), ``split_sigma_probe`` (leave-one-out zoom probe) and
``fm_demod_decimate`` (FM discriminator + decimating FIR).

XLA's command buffers (CUDA graphs) launch kernels without the op names
the stage attribution reads, so this script turns them off
(``--xla_gpu_enable_command_buffer=``) before JAX starts; each kernel is
then its own launch, which adds a few microseconds per kernel to the
device window compared with a normal run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

_FLAG = "--xla_gpu_enable_command_buffer="
if _FLAG not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               + _FLAG).strip()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tdoa_tpu.utils.profiling import device_stage_times  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write JSON here")
    args = p.parse_args(argv)

    info = chip_smoke.phase_device("gpu")
    csv = chip_smoke.repo_file("lat-lon-table.csv")
    workdir = tempfile.mkdtemp(prefix="stage_trace_")
    result = {"device": info, "seconds": chip_smoke.SECONDS,
              "xla_flags": os.environ["XLA_FLAGS"]}
    try:
        dats = chip_smoke.phase_simulate(workdir, chip_smoke.SECONDS, csv)
        for label, extra in (("batch", []), ("fm", ["--mode", "fm"])):
            chip_smoke.run_processor(dats, csv, extra)  # compile
            tdir = os.path.join(workdir, "trace_" + label)
            chip_smoke.run_processor(dats, csv, ["--trace", tdir, *extra])
            st = device_stage_times(tdir)
            result[label] = st
            stages = ", ".join(f"{k} {v / 1e6:.3f} ms"
                               for k, v in st["scopes"].items())
            print(f"[stage_trace] {label}: device {st['device_ns'] / 1e6:.3f}"
                  f" ms, busy {st['busy_ns'] / 1e6:.3f} ms of window "
                  f"{st['window_ns'] / 1e6:.3f} ms, {st['events']} events;"
                  f" {stages}", flush=True)
            for name, ns, _ in st["longest"]:
                print(f"[stage_trace] {label} longest: {ns / 1e6:.3f} ms "
                      f"{name[:100]}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    from tdoa_tpu.utils.platform import gpu_name_power_limit

    result["card"] = gpu_name_power_limit()
    print(f"card: {result['card']}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
