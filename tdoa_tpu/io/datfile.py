"""The ``.dat`` capture codec — the system's central data contract.

A capture is interleaved unsigned-8-bit I/Q at 2 Msps, centered at 127.5,
laid out as three equal sample blocks ``[REF | TGT | REF]`` produced by the
2-frequency capture tool (reference: collector.go:83-85,
processor.go:196-200, processor.go:208-238, rtl_sdr.c:19-25).

Byte value ``b`` decodes to ``(b - 127.5) / 127.5`` (processor.go:198-200);
clipping means touching 0 or 255 (analyzer.go semantics) — encode/decode here
is bit-faithful so the quality tools keep their meaning.

Decoding is done on-device: the u8 buffer is shipped to the accelerator and
widened there, so host↔device traffic is 1 byte/sample-component instead of 8.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tdoa_tpu.ops.cplx import C
from tdoa_tpu.utils.constants import IQ_CENTER, IQ_SCALE, NUM_BLOCKS


def bytes_to_iq_planar(raw: jax.Array) -> C:
    """Decode interleaved u8 I/Q bytes to planar float32 (re, im).

    ``raw`` is a uint8 array of even length ``2*n``; returns C with shape
    ``[n]``. Jittable (no complex dtype); runs on device so only bytes
    cross the host↔device boundary (1 byte/component vs 8).
    """
    x = (raw.astype(jnp.float32) - IQ_CENTER) / IQ_SCALE
    pairs = x.reshape(-1, 2)
    return C(pairs[:, 0], pairs[:, 1])


def u16_to_iq_planar(packed: jax.Array) -> C:
    """Decode I/Q from little-endian-packed uint16 words (I = low byte,
    Q = high byte) to planar float32 (re, im).

    ``bytes_to_iq_planar``'s ``reshape(-1, 2)`` + column-slice
    deinterleave works on an awkward [n, 2] layout. Viewing the same
    bytes as uint16 on the host (free) turns the deinterleave into two
    bitwise ops on a natural 1-D array — the same values, to within one
    float32 ulp where XLA fuses the division differently.
    """
    lo = (packed & jnp.uint16(0xFF)).astype(jnp.float32)
    hi = (packed >> jnp.uint16(8)).astype(jnp.float32)
    re = (lo - IQ_CENTER) / IQ_SCALE
    im = (hi - IQ_CENTER) / IQ_SCALE
    return C(re, im)


def iq_bytes_as_u16(raw: np.ndarray) -> np.ndarray:
    """Host-side zero-copy view of interleaved u8 I/Q as packed uint16
    (for ``u16_to_iq_planar``). Handles byte order explicitly."""
    u16 = raw.view(np.uint16)
    if u16.dtype.byteorder == ">" or (
        u16.dtype.byteorder == "=" and not np.little_endian
    ):
        u16 = u16.byteswap()
    return u16


def bytes_to_iq(raw: jax.Array) -> jax.Array:
    """Decode interleaved u8 I/Q bytes to complex64 samples (host/CPU
    convenience; the device path is
    ``bytes_to_iq_planar``)."""
    p = bytes_to_iq_planar(raw)
    return jax.lax.complex(p.re, p.im)


def iq_to_bytes(iq) -> jax.Array:
    """Encode complex or planar samples to interleaved u8 I/Q bytes.

    Values are scaled by 127.5, offset to 127.5 and clamped to [0, 255] —
    matching the simulators' quantization (simulator.go:146-161) up to
    the final integer step. The reference truncates (``byte(v)``,
    simulator.go:159-160); this encoder intentionally rounds to nearest
    instead, which halves the worst-case quantization error. The two
    differ by at most 1 LSB (for fractional parts >= 0.5).
    """
    if isinstance(iq, C):
        comps = jnp.stack([iq.re, iq.im], axis=-1)
    else:
        comps = jnp.stack([jnp.real(iq), jnp.imag(iq)], axis=-1)
    scaled = comps * IQ_SCALE + IQ_CENTER
    # floor(x + 0.5) = deterministic round-half-up (jnp.round would
    # round half-to-even). Deliberately NOT the reference's truncation —
    # see the docstring.
    return (
        jnp.clip(jnp.floor(scaled + 0.5), 0.0, 255.0)
        .astype(jnp.uint8)
        .reshape(-1)
    )


def split_blocks(iq):
    """Split a capture into its three equal blocks (ref1, tgt, ref2).

    Mirrors processor.go:208-267: block 1 and 3 are the reference
    frequency, block 2 is the target. Trailing samples beyond ``3*n`` are
    dropped (the capture tool writes exactly 3×n, but real files can carry
    partial trailing buffers). Works on complex arrays or planar C.
    """
    if isinstance(iq, C):
        n = iq.re.shape[0] // NUM_BLOCKS
        return (
            C(iq.re[:n], iq.im[:n]),
            C(iq.re[n : 2 * n], iq.im[n : 2 * n]),
            C(iq.re[2 * n : 3 * n], iq.im[2 * n : 3 * n]),
        )
    n = iq.shape[0] // NUM_BLOCKS
    return iq[:n], iq[n : 2 * n], iq[2 * n : 3 * n]


@dataclasses.dataclass
class DatCapture:
    """A decoded capture: device-resident planar blocks plus metadata."""

    ref1: C  # first reference-frequency block
    tgt: C  # target-frequency block
    ref2: C  # second reference-frequency block
    path: str = ""
    station: str = ""

    @property
    def block_len(self) -> int:
        return int(self.ref1.re.shape[0])

    @property
    def ref(self) -> C:
        """Both REF blocks concatenated — reference-parity view
        (processor.go:208-238 concatenates blocks 1+3)."""
        return C(
            jnp.concatenate([self.ref1.re, self.ref2.re]),
            jnp.concatenate([self.ref1.im, self.ref2.im]),
        )


_decode16 = jax.jit(u16_to_iq_planar)


def load_dat(path: str, station: str = "") -> DatCapture:
    """Load and decode a ``.dat`` capture file.

    The raw bytes are memory-mapped on the host, viewed as packed uint16
    words (zero-copy), shipped to device, and widened to planar float32
    there (processor.go:166-205 equivalent, without the host-side
    convert loop).
    """
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    usable = (len(raw) // (2 * NUM_BLOCKS)) * (2 * NUM_BLOCKS)
    packed = iq_bytes_as_u16(np.ascontiguousarray(raw[:usable]))
    iq = _decode16(jnp.asarray(packed))
    ref1, tgt, ref2 = split_blocks(iq)
    return DatCapture(ref1=ref1, tgt=tgt, ref2=ref2, path=path, station=station)


def save_dat(path: str, ref1, tgt, ref2) -> int:
    """Write three complex blocks as a byte-contract ``.dat`` file.

    Returns the number of bytes written. Blocks must be equal length
    (the collector's validateDataFile checks size = 3×n,
    collector.go:178-203).
    """
    if not (ref1.shape[0] == tgt.shape[0] == ref2.shape[0]):
        raise ValueError("all three blocks must have equal length")
    chunks = [np.asarray(iq_to_bytes(b)) for b in (ref1, tgt, ref2)]
    with open(path, "wb") as f:
        for c in chunks:
            f.write(c.tobytes())
    return os.path.getsize(path)
