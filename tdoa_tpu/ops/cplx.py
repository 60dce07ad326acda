"""Planar complex arithmetic: (re, im) array pairs.

Every device-side signal in the hot path is *planar*: a pair of real
float32 arrays. These helpers keep that code readable; XLA fuses them
into the surrounding elementwise work at zero cost.

Host-side/CPU code (tests, simulators) may still use numpy/jnp complex —
``from_complex`` / ``to_complex`` convert at the boundary.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class C(NamedTuple):
    """A planar complex tensor."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def __add__(self, o: "C") -> "C":
        return C(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "C") -> "C":
        return C(self.re - o.re, self.im - o.im)

    def __mul__(self, o):
        if isinstance(o, C):
            return C(
                self.re * o.re - self.im * o.im,
                self.re * o.im + self.im * o.re,
            )
        return C(self.re * o, self.im * o)

    def conj(self) -> "C":
        return C(self.re, -self.im)

    def mul_conj(self, o: "C") -> "C":
        """self * conj(o) — the cross-spectrum primitive."""
        return C(
            self.re * o.re + self.im * o.im,
            self.im * o.re - self.re * o.im,
        )

    def abs2(self) -> jax.Array:
        return self.re * self.re + self.im * self.im

    def abs(self) -> jax.Array:
        return jnp.sqrt(self.abs2())

    def angle(self) -> jax.Array:
        return jnp.arctan2(self.im, self.re)

    def scale(self, s) -> "C":
        return C(self.re * s, self.im * s)


def zeros(shape, dtype=jnp.float32) -> C:
    return C(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype))


def exp_i(theta: jax.Array) -> C:
    """exp(j·theta) as a planar pair."""
    return C(jnp.cos(theta), jnp.sin(theta))


def from_complex(x) -> C:
    """Split a complex (or real) array into planar parts. Host-side only
    on backends without complex support."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return C(jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32))
    z = x.astype(jnp.float32)
    return C(z, jnp.zeros_like(z))


def to_complex(x: C):
    """Planar → complex64 (host/CPU-side use: tests, plotting)."""
    return jax.lax.complex(x.re, x.im)


def stack(x: C, y: C, axis: int = 0) -> C:
    return C(
        jnp.stack([x.re, y.re], axis=axis), jnp.stack([x.im, y.im], axis=axis)
    )


def concatenate(parts: Tuple[C, ...], axis: int = 0) -> C:
    return C(
        jnp.concatenate([p.re for p in parts], axis=axis),
        jnp.concatenate([p.im for p in parts], axis=axis),
    )
