"""Plain float64 reference for the segmented cross-spectrum accumulator.

NumPy only — independent of JAX and of ``tdoa_tpu.ops`` — so it checks
``ops.corr._accumulate_cross_spectra`` (planar DFT-matmul FFT, float32 on
the device) against the textbook computation: cut the signal into
``seg_len`` segments, zero-pad each to ``fft_len``, FFT, and sum
``X_j·conj(X_i)`` per pair and ``|X_i|²`` per station.

Segments are processed one at a time, so memory stays O(n_st·fft_len)
whatever the capture length (a 100 s capture held at once in float64
would be ~10 GB).
"""

from __future__ import annotations

import numpy as np


def accumulate_cross_spectra(x, pair_idx, seg_len: int, fft_len: int):
    """``x``: complex [n_st, N] (or a (re, im) pair of real arrays).
    Returns (cross complex128 [m, F], psd float64 [n_st, F],
    energy float64 [n_st]) over the first ``N // seg_len`` whole
    segments — the same contract as ``_accumulate_cross_spectra``."""
    if isinstance(x, tuple):
        re, im = x
    else:
        re, im = np.real(x), np.imag(x)
    n_st, n = np.shape(re)
    pairs = np.asarray(pair_idx)
    n_seg = n // seg_len
    cross = np.zeros((len(pairs), fft_len), np.complex128)
    psd = np.zeros((n_st, fft_len), np.float64)
    energy = np.zeros(n_st, np.float64)
    for s in range(n_seg):
        sl = slice(s * seg_len, (s + 1) * seg_len)
        seg = (np.asarray(re[:, sl], np.float64)
               + 1j * np.asarray(im[:, sl], np.float64))
        xf = np.fft.fft(seg, n=fft_len, axis=-1)
        cross += xf[pairs[:, 1]] * np.conj(xf[pairs[:, 0]])
        psd += np.abs(xf) ** 2
        energy += np.sum(np.abs(seg) ** 2, axis=-1)
    return cross, psd, energy


def relative_l2(got, want) -> float:
    """‖got − want‖₂ / ‖want‖₂ over all elements (complex or real)."""
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm((got - want).ravel())
                 / max(np.linalg.norm(want.ravel()), 1e-300))
