"""chip_smoke.py's phases at a tiny size on the CPU (the script itself
refuses to run without a GPU; see test_platform.py)."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from tdoa_tpu.cli.simulator import DEFAULT_TGT_TX  # noqa: E402

SECONDS = 0.3
TINY = ["--max-lag", "2000", "--seg-len", "16384"]
TGT = np.asarray(DEFAULT_TGT_TX, np.float64)
CSV = os.path.join(REPO, "lat-lon-table.csv")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    cs.phase_device("cpu")
    workdir = str(tmp_path_factory.mktemp("smoke"))
    dats = cs.phase_simulate(workdir, SECONDS, CSV)
    batch = cs.phase_process(dats, CSV, TGT, TINY, runs=1)
    return workdir, dats, batch


def test_phase_device_reports_cpu():
    info = cs.phase_device("cpu")
    assert info["platform"] == "cpu" and info["count"] >= 1


def test_phase_simulate_writes_three_files(capture):
    _, dats, _ = capture
    assert len(dats) == 3
    sizes = {os.path.getsize(p) for p in dats}
    assert sizes == {int(SECONDS * 2e6 / 3) * 3 * 2}


def test_phase_process_batch_fix(capture):
    _, _, batch = capture
    assert batch["fix_err_m"] <= cs.FIX_TOL_M


def test_phase_process_overlap(capture):
    _, dats, _ = capture
    rec = cs.phase_process(dats, CSV, TGT, ["--overlap-ingest", *TINY],
                           label="overlap", runs=1)
    assert rec["fix_err_m"] <= cs.FIX_TOL_M


def test_phase_process_rejects_far_fix(capture):
    _, dats, _ = capture
    far = TGT + np.array([0.01, 0.0, 0.0])  # ~1.1 km north
    with pytest.raises(AssertionError, match="from the planted"):
        cs.phase_process(dats, CSV, far, TINY, runs=1)


def test_fm_mode_runs(capture):
    _, dats, _ = capture
    rec = cs.run_processor(dats, CSV, ["--mode", "fm", *TINY])
    err = cs.horizontal_m(rec["fix"]["lat"], rec["fix"]["lon"], TGT)
    assert np.isfinite(err)


def test_phase_stream_uses_tail_ingest(capture, capsys):
    workdir, _, _ = capture
    rec = cs.phase_stream(workdir, CSV, TGT, SECONDS, TINY)
    assert "tail-ingest" in capsys.readouterr().err
    assert rec["fix"]["lat"] == pytest.approx(TGT[0], abs=1e-3)


def test_phase_parity(capture):
    _, dats, batch = capture
    out = cs.phase_parity(dats, CSV, batch, TGT, max_lag=2000,
                          seg_len=16384)
    assert max(out["cross_rel_l2"]) <= cs.CROSS_REL_L2_TOL
    assert out["tdoa_err_samples"] <= cs.TDOA_TRUTH_TOL


def test_truth_tdoa_is_antisymmetric():
    st = ("kx0u", "n3pay")
    a = cs.truth_tdoa_samples(CSV, st, [("kx0u", "n3pay")], TGT)
    b = cs.truth_tdoa_samples(CSV, st, [("n3pay", "kx0u")], TGT)
    assert a[0] == pytest.approx(-b[0])


def test_phase_four_cards_on_virtual_devices():
    """The --four-cards comparison on four of the CPU's virtual
    devices: sharded and single-device corrected TDOAs agree."""
    cs.phase_device("cpu")
    out = cs.phase_four_cards(1.2, CSV)
    assert out["max_abs_delta_samples"] < 1e-3
