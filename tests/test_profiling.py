"""Trace reduction and device sync (utils/profiling.py)."""

import jax
import jax.numpy as jnp
import pytest

from tdoa_tpu.utils import profiling
from tdoa_tpu.utils.profiling import StageTimer, device_stage_times

# A two-kernel GPU plane: 5 µs in the FFT stage, 4 µs (overlapping it
# by 3 µs) in the probe; plus a host plane that must be ignored.
_XSPACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 5000000
      stats { metadata_id: 1
        str_value: "jit(f)/segment_fft_accumulate/while/body/dot" } }
    events { metadata_id: 2 offset_ps: 2000000 duration_ps: 4000000
      stats { metadata_id: 1 str_value: "jit(f)/split_sigma_probe/mul" } }
  }
  event_metadata { key: 1 value { id: 1 name: "gemm" } }
  event_metadata { key: 2 value { id: 2 name: "fusion.2" } }
  stat_metadata { key: 1 value { id: 1 name: "name" } }
}
planes {
  id: 2
  name: "/host:CPU"
  lines {
    id: 1
    name: "python"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "segment_fft_accumulate" } }
}
"""


def test_device_stage_times_attributes_scopes():
    pd = jax.profiler.ProfileData.from_text_proto(_XSPACE)
    st = device_stage_times(pd)
    assert st["events"] == 2
    assert st["device_ns"] == pytest.approx(9000.0)
    assert st["busy_ns"] == pytest.approx(6000.0)  # union of intervals
    assert st["window_ns"] == pytest.approx(6000.0)
    assert st["scopes"]["segment_fft_accumulate"] == pytest.approx(5000.0)
    assert st["scopes"]["split_sigma_probe"] == pytest.approx(4000.0)
    assert st["scopes"]["fm_demod_decimate"] == 0.0
    assert [n for n, _, _ in st["longest"]] == ["gemm", "fusion.2"]


# Overlapping scope names: "fft" is a substring of "fft_accumulate",
# and one event sits in a path that nests both.
_NESTED = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000
      stats { metadata_id: 1 str_value: "jit(f)/fft_accumulate/dot" } }
    events { metadata_id: 1 offset_ps: 2000000 duration_ps: 3000000
      stats { metadata_id: 1
        str_value: "jit(f)/fft_accumulate/fft/while/body/dot" } }
    events { metadata_id: 1 offset_ps: 5000000 duration_ps: 7000000
      stats { metadata_id: 1
        str_value: "jit(f)/transpose(jvp(fft))/mul" } }
    events { metadata_id: 1 offset_ps: 12000000 duration_ps: 1000000
      stats { metadata_id: 1 str_value: "jit(f)/fftx/add" } }
  }
  event_metadata { key: 1 value { id: 1 name: "fusion" } }
  stat_metadata { key: 1 value { id: 1 name: "name" } }
}
"""


def test_device_stage_times_counts_each_event_once():
    """Each event counts toward the innermost scope that is a whole
    path element, never toward a scope it merely contains as a
    substring, so the stages sum to at most the device time."""
    pd = jax.profiler.ProfileData.from_text_proto(_NESTED)
    st = device_stage_times(pd, scopes=("fft", "fft_accumulate"))
    assert st["device_ns"] == pytest.approx(13000.0)
    assert st["scopes"]["fft_accumulate"] == pytest.approx(2000.0)
    assert st["scopes"]["fft"] == pytest.approx(10000.0)
    assert sum(st["scopes"].values()) <= st["device_ns"]


def test_device_stage_times_on_a_cpu_trace(tmp_path):
    """A real trace without a GPU plane reduces to zero device time."""
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    with profiling.trace(str(tmp_path)):
        f(x).block_until_ready()
    st = device_stage_times(str(tmp_path))
    assert st["events"] == 0 and st["device_ns"] == 0.0


def test_device_stage_times_needs_a_trace(tmp_path):
    with pytest.raises(FileNotFoundError):
        device_stage_times(str(tmp_path))


def test_sync_waits_on_every_leaf(monkeypatch):
    seen = []
    monkeypatch.setattr(jax, "block_until_ready", lambda t: seen.append(t))
    tree = {"a": jnp.ones(3), "b": [jnp.zeros(2), 4]}
    profiling.sync(tree)
    assert seen == [tree]


def test_stage_timer_accumulates_and_reports():
    t = StageTimer()
    for _ in range(2):
        with t.stage("correlate"):
            t.observe([jnp.ones(4)])
    assert t.order == ["correlate"] and t.times["correlate"] > 0
    assert "correlate" in t.report()
