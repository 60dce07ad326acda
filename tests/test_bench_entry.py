"""Entry-point smoke tests: bench.py and __graft_entry__ must never
break — they run unattended."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_emits_valid_json():
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        BENCH_SECONDS="0.3",
        BENCH_MAX_LAG="1000",
        BENCH_SEG=str(1 << 16),
        PYTHONPATH=REPO,
    )
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("{")][-1]
    d = json.loads(line)
    assert d["metric"] == "corr_throughput"
    assert d["unit"] == "Msamples/s/chip"
    assert d["value"] > 0
    assert "vs_baseline" in d
    # A CPU rehearsal names the CPU, never a card.
    assert d["detail"]["device"]["platform"] == "cpu"
    assert d["detail"]["compilation_cache"]["dir"] is None
    # Headline is min-of-reps: never slower than the median throughput.
    assert d["value"] >= d["detail"]["median_msamples_per_s"] - 1e-6
    full = d["detail"]["full_path"]
    assert full["full_path_s"] > 0 and full["overlap_path_s"] > 0


def test_bench_refuses_implicit_cpu():
    """Without an explicit JAX_PLATFORMS=cpu, a host with no GPU is
    refused: bench.py never reports a CPU run as a device measurement."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="", BENCH_SECONDS="0.3")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert r.returncode != 0
    assert "JAX_PLATFORMS=cpu" in r.stderr
    assert not [l for l in r.stdout.splitlines() if l.startswith("{")]


def test_graft_entry_contract():
    code = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax; jax.config.update("jax_platforms", "cpu")
import sys; sys.path.insert(0, %r)
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
assert len(out) == 10
g.dryrun_multichip(8)
g.dryrun_multichip(4)
print("GRAFT OK")
""" % REPO
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "GRAFT OK" in r.stdout


def test_dryrun_multichip_self_forces_cpu_mesh():
    """Regression: dryrun_multichip may be called in a process whose
    backend is ALREADY initialized (possibly on an accelerator client)
    with no device-count forcing in the environment. The
    function must rebuild an 8-device CPU backend itself. Hermetic
    analogue: a 1-device CPU backend initialized before the call."""
    code = """
import sys; sys.path.insert(0, %r)
import jax
assert len(jax.devices()) == 1, jax.devices()   # hostile: backend frozen small
import __graft_entry__ as g
g.dryrun_multichip(8)
print("SELF-FORCED OK")
""" % REPO
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SELF-FORCED OK" in r.stdout
