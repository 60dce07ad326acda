"""Multi-chip scaling: shard the capture's time axis over a device mesh.

The reference has no software communication backend at all — its three
stations share data by scp (SURVEY.md §2.5). Here one long capture is
**sequence-parallel** across devices. Each device holds a contiguous
chunk of every station's signal, FFTs its local segments, and
accumulates partial cross-power spectra; one ``psum`` over the mesh
(NCCL over NVLink on a multi-GPU host) merges the accumulators (a few
MB — tiny next to the capture), and the cheap tail (GCC weighting, inverse FFT, peak
search, solver) runs replicated. Communication volume is O(fft_len·pairs),
independent of capture length — the design scales to arbitrarily long
captures at near-perfect efficiency.

Built on ``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives; no
hand-rolled NCCL/MPI analogue is needed or wanted.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tdoa_tpu.ops.corr import (
    CorrResult,
    _accumulate_cross_spectra,
    _combine_splits,
    _finish_correlation,
    clock_correct_blocks,
    resolve_seg,
    split_k,
)
from tdoa_tpu.ops.cplx import C
from tdoa_tpu.utils.constants import DEFAULT_MAX_LAG


def make_mesh(n_devices: Optional[int] = None, axis: str = "sp") -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def correlate_pairs_sharded(
    x: C,  # [n_st, N] planar
    pair_idx: jax.Array,
    mesh: Mesh,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "ht",
    eps: float = 1e-3,
    refine: str = "phase",
    axis: str = "sp",
) -> CorrResult:
    """Sequence-parallel GCC correlation: time axis sharded over ``mesh``.

    Each device accumulates cross-spectra for its contiguous chunk of the
    capture; accumulators merge with one psum; the finish stage runs
    replicated. Results are numerically identical to the single-chip path
    up to float reassociation (cross-segment edge products are dropped by
    segmentation in both paths).
    """
    d = mesh.shape[axis]
    n_st, n = x.re.shape
    per = (n // d)
    seg_len_r, fft_len = resolve_seg(per, max_lag, seg_len, None)
    use = per * d
    x = C(x.re[:, :use], x.im[:, :use])

    run = _sharded_program(
        mesh, axis, seg_len_r, fft_len, max_lag, weighting, eps, refine,
    )
    return run(x, pair_idx)


@functools.lru_cache(maxsize=None)
def _sharded_program(mesh, axis, seg_len_r, fft_len, max_lag, weighting,
                     eps, refine):
    """Build (once per configuration) the jitted shard_map program.

    The closure must NOT be rebuilt per call: a fresh function identity
    defeats jax's compilation cache and every invocation would re-trace
    and re-compile (~18 s per call measured on the virtual CPU mesh —
    fatal for streaming use). Mesh and all config knobs are hashable,
    so an lru_cache keyed on them gives each configuration exactly one
    compiled program.
    """
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(C(P(None, axis), P(None, axis)), P(None)),
        out_specs=CorrResult(P(), P(), P(), P(), P(), P(), P()),
    )
    def run(xl: C, pairs):
        local_n = xl.re.shape[1]
        cross, psd, energy = _accumulate_cross_spectra(
            xl, pairs, seg_len_r, fft_len
        )
        local_segs = local_n // seg_len_r
        # Total averaged segments behind the psum'd accumulators —
        # debiases the HT coherence exactly like the single-chip path.
        d = mesh.shape[axis]
        n_seg = local_segs * d
        K = split_k(n_seg) if refine == "phase" else 0
        while K > 1 and d % K != 0:
            K //= 2
        if K >= 2:
            # Split empirical error bar at feature parity with the
            # single-chip paths: the time axis is sharded contiguously,
            # so device groups idx // (d/K) hold exactly the capture's
            # K contiguous slices. Stack the masked accumulators and
            # psum ONCE — same collective count as before at Kx payload
            # (still O(fft_len·pairs), independent of capture length).
            gid = jax.lax.axis_index(axis) // (d // K)

            def groups(t):
                s = jax.lax.psum(
                    jnp.stack([
                        t * (gid == k).astype(t.dtype) for k in range(K)
                    ]),
                    axis,
                )
                return [s[k] for k in range(K)]

            crs = groups(cross.re)
            cis = groups(cross.im)
            pss = groups(psd)
            ens = groups(energy)
            return _combine_splits(
                [(C(crs[k], cis[k]), pss[k], ens[k]) for k in range(K)],
                pairs, max_lag, weighting, eps, fft_len, n_seg,
            )
        cross = C(
            jax.lax.psum(cross.re, axis), jax.lax.psum(cross.im, axis)
        )
        psd = jax.lax.psum(psd, axis)
        energy = jax.lax.psum(energy, axis)
        return _finish_correlation(
            cross, psd, energy, pairs, max_lag, weighting, eps, fft_len,
            refine, n_seg=n_seg,
        )

    return jax.jit(run)


def process_blocks_sharded(
    ref1: C,  # [n_st, L] planar
    tgt: C,
    ref2: C,
    pair_idx: jax.Array,
    ref_geo_tdoa: jax.Array,
    mesh: Mesh,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "ht",
    clock_correction: bool = True,
    axis: str = "sp",
):
    """The full multi-chip processing step: all 3 blocks × all pairs,
    sequence-parallel, with clock correction. Mirrors
    pipeline.process_blocks but sharded; returns the same 10-tuple
    (..., corrected_std, tgt_correlation_window, tgt_std,
    block_windows_complex).
    """
    n_st = ref1.re.shape[0]
    m = pair_idx.shape[0]
    xr = jnp.concatenate([ref1.re, tgt.re, ref2.re], axis=0)
    xi = jnp.concatenate([ref1.im, tgt.im, ref2.im], axis=0)
    xr = xr - jnp.mean(xr, axis=-1, keepdims=True)
    xi = xi - jnp.mean(xi, axis=-1, keepdims=True)
    offsets = jnp.arange(3, dtype=jnp.int32)[:, None, None] * n_st
    all_pairs = (pair_idx[None, :, :] + offsets).reshape(3 * m, 2)
    res = correlate_pairs_sharded(
        C(xr, xi), all_pairs, mesh,
        max_lag=max_lag, seg_len=seg_len, weighting=weighting, axis=axis,
    )
    return clock_correct_blocks(
        res.delay.reshape(3, m),
        res.delay_std.reshape(3, m),
        res.quality.reshape(3, m),
        res.peak_value.reshape(3, m),
        res.corr.reshape(3, m, -1),
        res.corr_re.reshape(3, m, -1),
        res.corr_im.reshape(3, m, -1),
        ref_geo_tdoa, clock_correction,
    )
