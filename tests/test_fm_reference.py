"""fm_demodulate (the device FM chain: discriminator → DC removal →
strided FIR decimation) against a float64 NumPy reference chain."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tdoa_tpu.dsp.filters import lowpass_taps
from tdoa_tpu.dsp.fm import fm_demodulate
from tdoa_tpu.ops.cplx import from_complex
from tdoa_tpu.sim import bandlimited_noise

FS = 2e6
DEV = 25e3


def _fm_iq(n, seed=0, lo_offset_hz=0.0):
    audio = np.asarray(bandlimited_noise(jax.random.PRNGKey(seed), n, 5e3, FS),
                       np.float64)
    phase = 2 * np.pi * DEV / FS * np.cumsum(audio)
    t = np.arange(n) / FS
    iq = np.exp(1j * (phase + 2 * np.pi * lo_offset_hz * t))
    return iq.astype(np.complex64), audio


def _reference_chain(iq, decim, num_taps=129):
    """float64: pairwise-product discriminator (d[0] = 0), mean removal,
    then the 'SAME'-padded strided FIR that lax.conv computes."""
    z = iq.astype(np.complex128)
    d = np.concatenate([[0.0], np.angle(z[1:] * np.conj(z[:-1]))])
    d = d * FS / (2 * np.pi) / DEV
    d = d - d.mean()
    taps = lowpass_taps(0.45 * FS / decim, FS, num_taps).astype(np.float64)
    k = len(taps)
    n = len(d)
    n_out = -(-n // decim)
    total = max((n_out - 1) * decim + k - n, 0)
    lo = total // 2
    pad = np.concatenate([np.zeros(lo), d, np.zeros(total - lo + k)])
    idx = np.arange(n_out)[:, None] * decim + np.arange(k)[None, :]
    return pad[idx] @ taps


def _device(iq, decim):
    return np.asarray(fm_demodulate(from_complex(jnp.asarray(iq)), FS,
                                    decim=decim, deviation_hz=DEV),
                      np.float64)


@pytest.mark.parametrize("decim", [4, 8, 16])
def test_fm_demodulate_matches_float64_chain(decim):
    iq, _ = _fm_iq(1 << 15, seed=decim)
    got = _device(iq, decim)
    want = _reference_chain(iq, decim)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("n", [10_000, 65_535, 32 * 1024 + 7])
def test_fm_demodulate_short_and_ragged(n):
    """Lengths that are no multiple of the decimation: the output has
    ceil(n/decim) samples and still matches the reference chain."""
    iq, _ = _fm_iq(n, seed=n % 97)
    got = _device(iq, 16)
    want = _reference_chain(iq, 16)
    assert got.shape == (-(-n // 16),)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_fm_demodulate_lo_offset_becomes_dc():
    """An LO offset is a constant instantaneous-frequency bias, i.e. DC
    in the discriminator output — which the chain removes."""
    iq0, _ = _fm_iq(1 << 15, seed=4)
    iq1, _ = _fm_iq(1 << 15, seed=4, lo_offset_hz=3e3)
    a0 = _device(iq0, 16)
    a1 = _device(iq1, 16)
    np.testing.assert_allclose(a1[20:-20], a0[20:-20], atol=5e-3)
    np.testing.assert_allclose(a1, _reference_chain(iq1, 16), atol=2e-4)


def test_fm_demodulate_recovers_audio():
    iq, audio = _fm_iq(1 << 16, seed=3)
    got = _device(iq, 16)
    want = audio.reshape(-1, 16).mean(-1)
    r = np.corrcoef(got[50:-50], want[50:-50])[0, 1]
    assert r > 0.99
