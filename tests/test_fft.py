"""DFT-matmul FFT vs numpy reference: exactness across sizes, batching, padding."""

import numpy as np
import jax.numpy as jnp
import pytest

from tdoa_tpu.ops.cplx import C, from_complex, to_complex
from tdoa_tpu.ops import fft as mfft


def _rand_c(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("n", [8, 128, 256, 1024, 4096, 1 << 15])
def test_fft_matches_numpy(n):
    x = _rand_c((n,), seed=n)
    got = to_complex(mfft.fft(from_complex(jnp.asarray(x))))
    want = np.fft.fft(x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-3 * np.sqrt(n))


@pytest.mark.parametrize("n", [256, 4096, 1 << 14])
def test_ifft_roundtrip(n):
    x = _rand_c((n,), seed=n + 1)
    xp = from_complex(jnp.asarray(x))
    back = to_complex(mfft.ifft(mfft.fft(xp)))
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-4 * np.sqrt(n))


def test_batched_fft():
    x = _rand_c((5, 512), seed=3)
    got = to_complex(mfft.fft(from_complex(jnp.asarray(x))))
    want = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=0.05)


def test_zero_padding_matches_numpy():
    x = _rand_c((1000,), seed=9)
    got = to_complex(mfft.fft(from_complex(jnp.asarray(x)), n=2048))
    want = np.fft.fft(x, n=2048)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=0.05)


def test_real_input_fft():
    x = np.random.default_rng(4).standard_normal(2048).astype(np.float32)
    got = to_complex(mfft.fft_real(jnp.asarray(x)))
    want = np.fft.fft(x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=0.05)


def test_non_pow2_rejected():
    x = from_complex(jnp.zeros(12, jnp.complex64))
    with pytest.raises(ValueError):
        mfft.fft(x)


def test_large_transform_precision():
    """2^20-point transform: phase accuracy must survive the multi-stage
    decomposition (integer-mod twiddles)."""
    n = 1 << 20
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    got = np.asarray(to_complex(mfft.fft(from_complex(jnp.asarray(x)))))
    want = np.fft.fft(x)
    err = np.abs(got - want)
    scale = np.sqrt(np.mean(np.abs(want) ** 2))
    assert err.max() / scale < 2e-3
