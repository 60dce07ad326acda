"""Correlator property tests: known integer and fractional delays must be
recovered to sub-sample precision (the reference had no such tests —
SURVEY.md §4 prescribes them for the rebuild)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tdoa_tpu.ops import correlate_pairs, correlation_lags
from tdoa_tpu.ops.corr import correlate_two
from tdoa_tpu.sim import fm_source, fractional_delay


def _sig(n=1 << 15, seed=0):
    return fm_source(jax.random.PRNGKey(seed), n, 2e6)


def test_self_correlation_unity():
    # simple_corr.go:31-45 semantics: self-correlation ≈ 1 at lag 0.
    a = _sig()
    res = correlate_two(a, a, max_lag=256, weighting="none")
    assert abs(float(res.delay)) < 1e-3
    assert float(res.peak_value) == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("d", [-173, -5, 0, 7, 200])
def test_integer_delay(d):
    a = _sig()
    b = fractional_delay(a, jnp.float32(d))
    res = correlate_two(a, b, max_lag=256, weighting="phat")
    assert float(res.delay) == pytest.approx(d, abs=0.02)


@pytest.mark.parametrize("d", [-41.37, -0.5, 0.25, 33.83])
def test_fractional_delay(d):
    a = _sig()
    b = fractional_delay(a, jnp.float32(d))
    res = correlate_two(a, b, max_lag=128, weighting="phat")
    assert float(res.delay) == pytest.approx(d, abs=0.05)


def test_delay_with_noise_and_carrier_rotation():
    key = jax.random.PRNGKey(3)
    a = _sig(seed=5)
    b = fractional_delay(a, jnp.float32(21.4)) * jnp.exp(1j * 2.1)
    k1, k2 = jax.random.split(key)
    na = 0.3 * (jax.random.normal(k1, a.shape) + 1j * jax.random.normal(k2, a.shape))
    kb1, kb2 = jax.random.split(jax.random.PRNGKey(9))
    nb = 0.3 * (jax.random.normal(kb1, a.shape) + 1j * jax.random.normal(kb2, a.shape))
    res = correlate_two(a + na, b + nb, max_lag=128, weighting="phat")
    assert float(res.delay) == pytest.approx(21.4, abs=0.2)
    assert float(res.quality) > 5.0


def test_uncorrelated_noise_low_peak():
    # simple_corr.go:64-80: noise vs signal correlates near zero.
    a = _sig(seed=1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    noise = jax.random.normal(k1, a.shape) + 1j * jax.random.normal(k2, a.shape)
    res = correlate_two(a, noise, max_lag=128, weighting="none")
    assert float(res.peak_value) < 0.2


def test_segmented_matches_single_fft():
    a = _sig(n=1 << 16, seed=11)
    b = fractional_delay(a, jnp.float32(-57.21))
    whole = correlate_two(a, b, max_lag=128, weighting="phat")
    seg = correlate_two(a, b, max_lag=128, seg_len=1 << 13, weighting="phat")
    assert float(seg.delay) == pytest.approx(float(whole.delay), abs=0.05)


def test_segmentation_gains_snr():
    # Coherent accumulation over segments must dig a weak signal out:
    # the claimed integration gain of processor.go:770-783 made real.
    a = _sig(n=1 << 18, seed=13)
    b = fractional_delay(a, jnp.float32(44.0))
    k1, k2 = jax.random.split(jax.random.PRNGKey(17))
    heavy = 4.0 * (jax.random.normal(k1, a.shape) + 1j * jax.random.normal(k2, a.shape))
    res = correlate_two(a, b + heavy, max_lag=256, seg_len=1 << 14, weighting="phat")
    # −12 dB per-sample SNR: finding the peak at all is the point; the
    # residual sits at the CRLB (~1 sample here).
    assert float(res.delay) == pytest.approx(44.0, abs=1.5)


def test_all_pairs_batched():
    base = _sig(seed=21)
    delays = [0.0, 12.5, -31.25]
    x = jnp.stack([fractional_delay(base, jnp.float32(d)) for d in delays])
    pairs = jnp.array([[0, 1], [0, 2], [1, 2]], jnp.int32)
    res = correlate_pairs(x, pairs, max_lag=128, weighting="phat")
    want = [delays[1] - delays[0], delays[2] - delays[0], delays[2] - delays[1]]
    np.testing.assert_allclose(np.asarray(res.delay), want, atol=0.05)


def test_large_delay_small_segments():
    """NTP-scale clock offsets (the reason for the reference's ±20000
    window, ±10 ms at 2 Msps) must survive segments not much larger than
    the delay — segment-edge energy loss tapers but does not break the
    peak."""
    a = _sig(n=1 << 19, seed=33)
    b = fractional_delay(a, jnp.float32(15000.25))
    res = correlate_two(a, b, max_lag=20000, seg_len=1 << 16, weighting="ht")
    assert float(res.delay) == pytest.approx(15000.25, abs=0.05)
    assert float(res.quality) > 20


def test_correlation_lags_axis():
    lags = correlation_lags(5)
    np.testing.assert_array_equal(lags, np.arange(-5, 6))


def test_max_lag_validation():
    a = _sig(n=1024)
    with pytest.raises(ValueError):
        correlate_two(a, a, max_lag=2048)


@pytest.mark.parametrize("theta", [3.1, -3.1, np.pi, np.pi / 2])
def test_refine_robust_to_carrier_phase_intercept(theta):
    """A constant inter-receiver carrier phase near ±π used to split the
    wrapped phases into +π/−π clusters and blow up the slope fit (a
    stable ~1.6-sample bias in a simulated scene). The intercept
    recentering must hold the refine to sub-sample accuracy for ANY θ.
    Broadband signal so the coarse peak is exact and the refine (where
    the bug lived) is what's under test — with θ=π every bin of a
    broadband spectrum wrap-splits in the old code."""
    key = jax.random.PRNGKey(11)
    kr, ki = jax.random.split(key)
    n = 1 << 15
    a = (jax.random.normal(kr, (n,)) + 1j * jax.random.normal(ki, (n,))
         ).astype(jnp.complex64)
    b = fractional_delay(a, jnp.float32(-1.62))
    b = b * np.complex64(np.exp(1j * theta))
    res = correlate_two(a, b, max_lag=64, weighting="ht")
    assert float(res.delay) == pytest.approx(-1.62, abs=0.02)


def test_dc_heavy_input_stays_finite():
    """A DC-heavy capture, mean-removed as ``process_blocks`` does, must
    correlate to finite values under HT weighting (regression: an
    8-station hardware run had one station's REF block peg every pair at
    the window edge with quality=NaN)."""
    from tdoa_tpu.ops.corr import correlate_pairs_planar
    from tdoa_tpu.ops.cplx import C

    seg = 45056
    rng = np.random.default_rng(3)
    sig = rng.standard_normal(2 * seg).astype(np.float32) * 0.05
    re = np.stack([sig + 0.0055, np.roll(sig, 9) + 0.0048])
    im = np.stack([sig * 0.5 - 0.003, np.roll(sig, 9) * 0.5 + 0.004])
    re = re - re.mean(axis=-1, keepdims=True)
    im = im - im.mean(axis=-1, keepdims=True)
    res = correlate_pairs_planar(
        C(jnp.asarray(re), jnp.asarray(im)), jnp.asarray([[0, 1]], jnp.int32),
        max_lag=256, seg_len=seg, weighting="ht",
    )
    assert np.isfinite(np.asarray(res.corr)).all()
    assert np.isfinite(float(res.quality[0]))
    assert abs(float(res.delay[0]) - 9.0) < 0.1


def test_ht_weight_clamps_negative_psd_bin():
    """A PSD bin rounded slightly below zero must not NaN the HT sqrt
    (the clamp in ``_weight_factor``) and so zero or poison every bin:
    the bad bins get no weight, the healthy bins keep theirs."""
    from tdoa_tpu.ops.corr import _weight_factor
    from tdoa_tpu.ops.cplx import C

    rng = np.random.default_rng(5)
    f = 64
    cross = C(jnp.asarray(rng.standard_normal((1, f)), jnp.float32),
              jnp.asarray(rng.standard_normal((1, f)), jnp.float32))
    psd = np.abs(rng.standard_normal((2, f))).astype(np.float32) + 1.0
    psd[0, 3] = -1e-7
    psd[1, 7] = -3e-9
    w = _weight_factor(cross, jnp.asarray(psd),
                       jnp.asarray([[0, 1]], jnp.int32), "ht", 1e-3, n_seg=4)
    assert np.isfinite(np.asarray(w)).all()
    assert float(w[0, 3]) == 0.0 and float(w[0, 7]) == 0.0
    assert int(np.count_nonzero(np.asarray(w))) > f // 2
