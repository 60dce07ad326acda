"""The float32 device path pins its matmuls to Precision.HIGHEST.

A float32 matmul may otherwise run in TF32 on the GPU (10-bit mantissa,
no better than bf16 for the phase-slope delay refinement). CPU runs
cannot show the numerical difference, so these tests read the pin in
the traced programs instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tdoa_tpu.ops import fft as mfft
from tdoa_tpu.ops.cplx import C

HIGHEST = jax.lax.Precision.HIGHEST


def _precisions(fn, *args):
    """Every precision config on a dot_general/conv in ``fn``'s jaxpr
    (nested jaxprs included), as a list."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("dot_general",
                                      "conv_general_dilated"):
                found.append(eqn.params.get("precision"))
            for v in eqn.params.values():
                subs = v if isinstance(v, (list, tuple)) else [v]
                for sub in subs:
                    if hasattr(sub, "eqns"):  # Jaxpr
                        walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr)  # ClosedJaxpr

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _is_highest(p):
    if p is None:
        return False
    ps = p if isinstance(p, tuple) else (p, p)
    return all(q == HIGHEST for q in ps)


def _planar(shape):
    return C(jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32))


@pytest.mark.parametrize("n", [128, 4096, 1 << 16])
def test_fft_f32_pins_highest(n):
    found = _precisions(lambda x: mfft.fft(x), _planar((2, n)))
    assert found and all(_is_highest(p) for p in found), found


def test_ifft_pins_highest():
    found = _precisions(lambda x: mfft.ifft(x), _planar((2, 8192)))
    assert found and all(_is_highest(p) for p in found), found


def test_fft_bf16_keeps_default_precision():
    found = _precisions(lambda x: mfft.fft(x, precision="bf16"),
                        _planar((2, 4096)))
    assert found and not any(_is_highest(p) for p in found), found


def test_caf_pins_highest():
    from tdoa_tpu.ops.caf import caf_pairs

    x = _planar((2, 1 << 14))
    found = _precisions(
        lambda x: caf_pairs(x, jnp.array([[0, 1]], jnp.int32),
                            sample_rate=2e6, max_lag=64, seg_len=1024,
                            n_doppler=8),
        x,
    )
    assert len(found) >= 8 and all(_is_highest(p) for p in found), found


def test_zoom_dft_pins_highest():
    from tdoa_tpu.ops.corr import _zoom_corr_delay

    found = _precisions(
        lambda w, c: _zoom_corr_delay(w, c, 4096, 128),
        _planar((3, 4096)), jnp.zeros(3, jnp.float32),
    )
    assert len(found) == 4 and all(_is_highest(p) for p in found), found


def test_fir_conv_pins_highest():
    from tdoa_tpu.dsp.filters import fir_decimate

    found = _precisions(lambda x: fir_decimate(x, 8, 2e6),
                        jnp.zeros((2, 4096), jnp.float32))
    assert found and all(_is_highest(p) for p in found), found


def test_lm_solver_pins_highest():
    from tdoa_tpu.solve.multilateration import solve_tdoa_enu

    st = jnp.asarray(np.array([[0.0, 0, 0], [8e3, 2e3, 0], [3e3, 9e3, 0]],
                              np.float32))
    pairs = jnp.array([[0, 1], [0, 2], [1, 2]], jnp.int32)
    found = _precisions(lambda rd: solve_tdoa_enu(st, pairs, rd),
                        jnp.zeros(3, jnp.float32))
    assert found and all(_is_highest(p) for p in found), found
