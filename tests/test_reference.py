"""Device-path numerics against plain float64 references: the segmented
cross-spectrum accumulator (ops/reference.py), the split-σ zoom probe,
and the phase-slope refinement on long accumulations."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tdoa_tpu.ops.corr import (
    _accumulate_cross_spectra,
    _phase_slope_refine,
    _zoom_corr_delay,
)
from tdoa_tpu.ops.cplx import C
from tdoa_tpu.ops.reference import accumulate_cross_spectra, relative_l2
from tdoa_tpu.solve.multilateration import station_pairs


def _signals(n_st, n, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = np.stack([np.roll(base, 7 * k) for k in range(n_st)])
    x = x + 0.3 * (rng.standard_normal((n_st, n))
                   + 1j * rng.standard_normal((n_st, n)))
    return x.astype(np.complex64)


@pytest.mark.parametrize("n_st", [3, 5, 12])
@pytest.mark.parametrize("seg_len, fft_len", [(1000, 2048), (3072, 4096)])
def test_accumulator_matches_float64_reference(n_st, seg_len, fft_len):
    x = _signals(n_st, 5 * seg_len + 123, seed=n_st)
    pairs = station_pairs(n_st)
    cross, psd, energy = jax.jit(
        _accumulate_cross_spectra, static_argnums=(2, 3)
    )(C(jnp.asarray(x.real), jnp.asarray(x.imag)), jnp.asarray(pairs),
      seg_len, fft_len)
    ref_cross, ref_psd, ref_energy = accumulate_cross_spectra(
        x, pairs, seg_len, fft_len)
    got = np.asarray(cross.re, np.float64) + 1j * np.asarray(cross.im)
    assert relative_l2(got, ref_cross) < 1e-5
    assert relative_l2(np.asarray(psd), ref_psd) < 1e-5
    np.testing.assert_allclose(np.asarray(energy), ref_energy, rtol=1e-5)


def test_reference_accepts_planar_and_drops_ragged_tail():
    x = _signals(2, 2 * 512 + 100)
    a = accumulate_cross_spectra(x, [[0, 1]], 512, 1024)
    b = accumulate_cross_spectra((x.real, x.imag), [[0, 1]], 512, 1024)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    want = np.sum(np.abs(x[:, :1024].astype(np.complex128)) ** 2, axis=-1)
    np.testing.assert_allclose(a[2], want, rtol=1e-12)


def test_relative_l2():
    assert relative_l2([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert abs(relative_l2([3.0, 4.0], [0.0, 0.0 + 5.0]) - 1.0) < 0.5


@pytest.mark.parametrize("scale", [1.0, 1e4, 7e7])
def test_phase_slope_refine_survives_long_accumulations(scale):
    """|C| grows as seg·S with the accumulated segment count S; at a
    100 s capture (|C| ~ 7e7 per bin, white) the raw |C|² weights made
    the normal-equation products overflow float32 into NaN delays."""
    F = 65536
    f = np.fft.fftfreq(F)
    d = 12.3
    c = scale * np.exp(-2j * np.pi * f * d + 0.7j)
    cc = C(jnp.asarray(c.real[None], jnp.float32),
           jnp.asarray(c.imag[None], jnp.float32))
    for phase in (jnp.array([0.7], jnp.float32), None):
        delay, std, width = _phase_slope_refine(
            cc, jnp.array([12.0], jnp.float32), F, 20000, phase)
        assert np.isfinite(np.asarray(std)).all()
        assert abs(float(delay[0]) - d) < 1e-3


def _zoom_reference(wspec, coarse, F, half_width=16):
    """float64 zoom DFT: correlation at lags coarse+δ, δ ∈ [-hw, hw],
    then the same 3-point parabolic peak as ops.peaks."""
    f = np.fft.fftfreq(F)
    delta = np.arange(-half_width, half_width + 1)
    out = []
    for row, c0 in zip(wspec, coarse):
        lags = c0 + delta
        r = np.exp(2j * np.pi * np.outer(lags, f)) @ row
        mag = np.abs(r)
        k = int(np.argmax(mag))
        if 0 < k < len(mag) - 1:
            a, b, cc = mag[k - 1], mag[k], mag[k + 1]
            den = a - 2 * b + cc
            k = k + (0.5 * (a - cc) / den if den != 0 else 0.0)
        out.append(c0 + k - half_width)
    return np.array(out)


@pytest.mark.parametrize("seed", [0, 3])
def test_split_sigma_probe_negative_delays(seed):
    """The XLA split-σ probe (zoom DFT with the exact int32 deramp)
    against a float64 zoom DFT, for negative coarse delays."""
    rng = np.random.default_rng(seed)
    F, m = 4096, 3
    f = np.fft.fftfreq(F)
    true = -rng.uniform(5, 40, size=m)
    band = np.exp(-(f / 0.2) ** 2)
    spec = band * np.exp(-2j * np.pi * np.outer(true, f))
    spec = spec + 0.01 * (rng.standard_normal((m, F))
                          + 1j * rng.standard_normal((m, F)))
    coarse = np.round(true) - rng.integers(-3, 4, size=m)
    got = _zoom_corr_delay(
        C(jnp.asarray(spec.real, jnp.float32),
          jnp.asarray(spec.imag, jnp.float32)),
        jnp.asarray(coarse, jnp.float32), F, 128,
    )
    want = _zoom_reference(spec, coarse, F)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got), true, atol=0.1)
