"""Tests that need the card: float32 parity of the device accumulator at
a real width, with and without the HIGHEST pin. They skip on the CPU;
run them on a GPU with ``TDOA_TPU_TEST_GPU=1 pytest -m gpu tests/``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tdoa_tpu.ops import fft as mfft
from tdoa_tpu.ops.corr import _accumulate_cross_spectra
from tdoa_tpu.ops.cplx import C
from tdoa_tpu.ops.reference import accumulate_cross_spectra, relative_l2

SEG, FFT = 45536, 65536  # the processor's segment at max_lag 20000


def _capture(seed=0, n_seg=12):
    rng = np.random.default_rng(seed)
    n = n_seg * SEG
    base = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = np.stack([np.roll(base, d) for d in (0, 41, -82)])
    x = x + 0.5 * (rng.standard_normal(x.shape)
                   + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def _device_cross(x, dev):
    pairs = jnp.asarray(np.array([[0, 1], [0, 2], [1, 2]], np.int32))
    xr = jax.device_put(jnp.asarray(x.real), dev)
    xi = jax.device_put(jnp.asarray(x.imag), dev)
    fn = jax.jit(lambda a, b, p: _accumulate_cross_spectra(
        C(a, b), p, SEG, FFT))
    cross, _, _ = fn(xr, xi, pairs)
    return np.asarray(cross.re, np.float64) + 1j * np.asarray(cross.im)


@pytest.mark.gpu
def test_accumulator_parity_highest(gpu_device):
    x = _capture()
    want, _, _ = accumulate_cross_spectra(
        x, [[0, 1], [0, 2], [1, 2]], SEG, FFT)
    assert relative_l2(_device_cross(x, gpu_device), want) < 1e-5


@pytest.mark.gpu
def test_unpinned_matmuls_lose_precision(gpu_device, monkeypatch):
    """The pin matters on the card: at the backend's default matmul
    precision the same accumulation is measurably worse."""
    x = _capture(seed=1)
    want, _, _ = accumulate_cross_spectra(
        x, [[0, 1], [0, 2], [1, 2]], SEG, FFT)
    pinned = relative_l2(_device_cross(x, gpu_device), want)
    monkeypatch.setattr(mfft, "_mm_precision", lambda precision: None)
    unpinned = relative_l2(_device_cross(x, gpu_device), want)
    assert unpinned > 10 * pinned
