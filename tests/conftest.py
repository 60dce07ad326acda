"""Test configuration: force CPU with 8 virtual devices BEFORE jax import.

All tests run on the CPU backend so they are hermetic and fast; the same
code JIT-compiles unchanged for the GPU. The 8 virtual devices let the
multi-device sharding tests build a real ``jax.sharding.Mesh``. Tests
that need a GPU carry the ``gpu`` marker and skip on the CPU (see the
``gpu_device`` fixture).
"""

import os

# TDOA_TPU_TEST_GPU=1 leaves the default backend alone, for running the
# gpu-marked tests on a card: TDOA_TPU_TEST_GPU=1 pytest -m gpu tests/
ON_GPU = os.environ.get("TDOA_TPU_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # The CLIs default to the GPU; tests (and the CLI subprocesses they
    # spawn) run them on the CPU.
    os.environ["TDOA_TPU_PLATFORM"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def omaha_stations():
    """The reference deployment geometry (lat-lon-table.csv): three
    receivers around Omaha plus the NOAA reference transmitter and the
    KEVO target used for ground-truth runs."""
    return {
        "names": ("kx0u", "n3pay", "kf0mtl"),
        "station_lla": np.array(
            [
                [41.18660274289527, -95.96064116595667, 355.69],
                [41.24669616513154, -96.08366304481238, 329.0],
                [41.32916620016985, -96.03513381562004, 373.18],
            ]
        ),
        "ref_tx_lla": np.array([41.25703803095629, -95.95512763589404, 349.07]),
        "tgt_tx_lla": np.array([41.30888549464701, -96.02619229605524, 356.0]),
        "ref_freq": 162_400_000.0,
        "tgt_freq": 101_900_000.0,
    }


@pytest.fixture
def station_csv(tmp_path, omaha_stations):
    """A lat-lon-table.csv in the reference's format."""
    path = tmp_path / "lat-lon-table.csv"
    s = omaha_stations
    lines = ["Name,Latitude,Longitude,Elevation"]
    lines.append(
        "KEVO,{},{},{}".format(*s["tgt_tx_lla"])
    )
    lines.append("162400000,{},{},{}".format(*s["ref_tx_lla"]))
    for name, row in zip(s["names"], s["station_lla"]):
        lines.append(f"{name},{row[0]},{row[1]},{row[2]}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips when JAX sees
    none (decided here, at run time, never at collection)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run the gpu-marked tests on the card)")
    return devs[0]
