"""Tests for the .dat codec and station-table contracts (SURVEY.md §1)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tdoa_tpu.io import (
    bytes_to_iq,
    iq_to_bytes,
    load_dat,
    save_dat,
    split_blocks,
    load_station_table,
    station_from_filename,
)
from tdoa_tpu.io.stations import parse_epoch_from_filename


def test_bytes_to_iq_contract():
    # processor.go:198-200: (b - 127.5) / 127.5
    raw = jnp.array([0, 255, 127, 128], dtype=jnp.uint8)
    iq = np.asarray(bytes_to_iq(raw))
    assert iq.shape == (2,)
    np.testing.assert_allclose(iq[0].real, -1.0, atol=1e-6)
    np.testing.assert_allclose(iq[0].imag, 1.0, atol=1e-6)
    np.testing.assert_allclose(iq[1].real, -0.5 / 127.5, atol=1e-6)
    np.testing.assert_allclose(iq[1].imag, 0.5 / 127.5, atol=1e-6)


def test_iq_bytes_roundtrip():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, size=600, dtype=np.uint8)
    iq = bytes_to_iq(jnp.asarray(raw))
    back = np.asarray(iq_to_bytes(iq))
    np.testing.assert_array_equal(back, raw)


def test_split_blocks_ref_tgt_ref():
    n = 30
    iq = jnp.arange(n) + 0j
    r1, t, r2 = split_blocks(iq)
    assert r1.shape == t.shape == r2.shape == (10,)
    np.testing.assert_array_equal(np.asarray(t), np.arange(10, 20))


def test_dat_file_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    blocks = [
        (rng.uniform(-0.9, 0.9, 64) + 1j * rng.uniform(-0.9, 0.9, 64)).astype(
            np.complex64
        )
        for _ in range(3)
    ]
    path = str(tmp_path / "kx0u-1700000000.dat")
    nbytes = save_dat(path, *[jnp.asarray(b) for b in blocks])
    assert nbytes == 3 * 64 * 2
    cap = load_dat(path, station="kx0u")
    assert cap.block_len == 64
    # u8 quantization error ≤ half an LSB per component → ≤ √2·0.5 LSB in
    # complex magnitude. Blocks come back planar; recombine.
    from tdoa_tpu.ops.cplx import to_complex

    tol = 0.5 * np.sqrt(2) / 127.5 + 1e-7
    for got, want in zip((cap.ref1, cap.tgt, cap.ref2), blocks):
        np.testing.assert_allclose(np.asarray(to_complex(got)), want, atol=tol)


def test_save_dat_rejects_unequal_blocks(tmp_path):
    a = jnp.zeros(8, jnp.complex64)
    b = jnp.zeros(9, jnp.complex64)
    with pytest.raises(ValueError):
        save_dat(str(tmp_path / "x.dat"), a, b, a)


def test_station_table(station_csv):
    table = load_station_table(station_csv, reference_freq=162_400_000.0)
    # The frequency-named row becomes the reference transmitter
    # (processor.go:96-98), everything else is a site.
    assert table.reference_tx is not None
    assert abs(table.reference_tx.lat - 41.257038) < 1e-4
    assert "kx0u" in table and "n3pay" in table and "kf0mtl" in table
    assert "KEVO" in table  # non-receiver rows still resolvable by name
    lla = table.lla_array(["kx0u", "n3pay", "kf0mtl"])
    assert lla.shape == (3, 3)


def test_station_from_filename():
    names = ["kx0u", "n3pay", "kf0mtl"]
    assert station_from_filename("/data/kx0u-1723000000.dat", names) == "kx0u"
    assert station_from_filename("sim-n3pay-99.dat", names) == "n3pay"
    assert station_from_filename("unknown-1.dat", names) is None
    assert parse_epoch_from_filename("kx0u-1723000000.dat") == 1723000000
    assert parse_epoch_from_filename("kx0u.dat") is None


def test_load_dat_decodes_float32_exactly(tmp_path):
    """``load_dat``'s packed-u16 decode and ``bytes_to_iq_planar`` both
    yield float32 planes within one float32 ulp of the byte-wise decode
    ``(b - 127.5) / 127.5`` of each interleaved I/Q byte (XLA may divide
    by a reciprocal)."""
    from tdoa_tpu.io.datfile import bytes_to_iq_planar

    rng = np.random.default_rng(11)
    n = 4096
    raw = rng.integers(0, 256, size=3 * 2 * n, dtype=np.uint8)
    p = tmp_path / "f32-test.dat"
    p.write_bytes(raw.tobytes())
    cap = load_dat(str(p))
    want = ((raw.astype(np.float32) - np.float32(127.5))
            / np.float32(127.5)).reshape(3, n, 2)
    via_u8 = bytes_to_iq_planar(jnp.asarray(raw))
    for k, blk in enumerate((cap.ref1, cap.tgt, cap.ref2)):
        assert blk.re.dtype == blk.im.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(blk.re), want[k, :, 0],
                                   rtol=0, atol=2.0 ** -23)
        np.testing.assert_allclose(np.asarray(blk.im), want[k, :, 1],
                                   rtol=0, atol=2.0 ** -23)
        np.testing.assert_allclose(np.asarray(via_u8.re)[k * n:(k + 1) * n],
                                   want[k, :, 0], rtol=0, atol=2.0 ** -23)
        np.testing.assert_allclose(np.asarray(via_u8.im)[k * n:(k + 1) * n],
                                   want[k, :, 1], rtol=0, atol=2.0 ** -23)
