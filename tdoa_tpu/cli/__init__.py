"""Command-line tools mirroring the reference binaries (SURVEY.md §2.1).

Each tool is ``python -m tdoa_tpu.cli.<name>`` with the reference's
argument contract. Tools run on the GPU by default; set
``TDOA_TPU_PLATFORM=cpu`` to run a tool's compute on the CPU.
"""

import os


def rewrite_prior_argv(argv):
    """argparse treats "-33.9,18.4,25" (southern-hemisphere prior) as an
    option string, not a value; rewrite to the --prior=VALUE form."""
    argv = list(argv)
    for k, a in enumerate(argv[:-1]):
        if a == "--prior" and argv[k + 1].startswith("-"):
            argv[k:k + 2] = ["--prior=" + argv[k + 1]]
            break
    return argv


def parse_prior(spec, error):
    """Parse a ``LAT,LON,RADIUS_KM`` coverage-prior spec into the
    ``(lat_deg, lon_deg, radius_m)`` tuple ProcessorConfig.prior takes;
    calls ``error(msg)`` (argparse-style, does not return) on bad input."""
    try:
        lat_s, lon_s, rad_s = spec.split(",")
        prior = (float(lat_s), float(lon_s), float(rad_s) * 1000.0)
    except ValueError:
        error("--prior expects LAT,LON,RADIUS_KM (e.g. 41.2,-96.0,25)")
    if not (-90.0 <= prior[0] <= 90.0 and -180.0 <= prior[1] <= 180.0
            and prior[2] > 0.0):
        error("--prior out of range: |lat|<=90, |lon|<=180, radius>0")
    return prior


def setup_platform() -> str:
    """Pick the JAX platform for a CLI run before any computation:
    ``TDOA_TPU_PLATFORM`` (``gpu`` by default, or ``cpu``). A GPU run on
    a host without one fails with a message naming the CPU setting; it
    never carries on on the CPU. Returns the platform."""
    from tdoa_tpu.utils.platform import select_platform, setup_compilation_cache

    plat = select_platform(os.environ.get("TDOA_TPU_PLATFORM", "gpu"))
    setup_compilation_cache(plat)
    return plat
