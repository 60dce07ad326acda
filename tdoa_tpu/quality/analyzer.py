"""Signal-quality analysis — analyzer.go / fast_analyzer.go capability.

Per-block metrics computed in one jitted device pass over the raw u8
bytes (the reference scans byte-by-byte on the host, analyzer.go:141-183):
DC offset, RMS power, I/Q imbalance, clipping (bytes touching 0/255 —
analyzer.go semantics preserved bit-exactly by analyzing *bytes*, not
floats), overload/dead-zone flags, plus the percentile-split spectral SNR
(dsp/snr.py). The recommendation engine and TDOA-suitability verdict
mirror analyzer.go:379-629 / 460-471.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tdoa_tpu.dsp.snr import spectral_snr
from tdoa_tpu.io.datfile import iq_bytes_as_u16
from tdoa_tpu.ops.cplx import C
from tdoa_tpu.utils.constants import IQ_CENTER, IQ_SCALE, NUM_BLOCKS


@dataclasses.dataclass
class BlockStats:
    """Metrics for one frequency block (REF or TGT)."""

    snr_db: float
    power: float  # mean |x|², full scale ≡ 1
    rms: float
    dc_offset_i: float  # in byte units relative to 127.5
    dc_offset_q: float
    iq_imbalance_db: float  # 10·log10(P_I / P_Q)
    clip_fraction: float  # bytes at 0 or 255
    overload_fraction: float  # |sample| > 0.9 full scale
    dead_fraction: float  # bytes within ±1 of center (127/128)
    min_byte: int
    max_byte: int

    @property
    def is_clipping(self) -> bool:
        return self.clip_fraction > 1e-4  # analyzer.go clipping flag

    @property
    def is_overloaded(self) -> bool:
        return self.overload_fraction > 0.01

    @property
    def is_dead(self) -> bool:
        return self.dead_fraction > 0.99

    @property
    def is_noisy(self) -> bool:
        return self.snr_db < 10.0


@functools.partial(jax.jit, static_argnames=("nfft",))
def _block_metrics(packed: jax.Array, nfft: int = 8192):
    """One device pass over u16-packed I/Q bytes → all scalar metrics.

    ``packed`` is the capture's interleaved u8 bytes viewed as
    little-endian uint16 (I = low byte, Q = high byte — see
    io.datfile.iq_bytes_as_u16). The bitwise split avoids strided
    slices of a u8 array, is layout-friendly and byte-exact."""
    i_u8 = packed & jnp.uint16(0xFF)
    q_u8 = packed >> jnp.uint16(8)
    i_bytes = i_u8.astype(jnp.float32)
    q_bytes = q_u8.astype(jnp.float32)
    dc_i = jnp.mean(i_bytes) - IQ_CENTER
    dc_q = jnp.mean(q_bytes) - IQ_CENTER
    fi = (i_bytes - IQ_CENTER) / IQ_SCALE
    fq = (q_bytes - IQ_CENTER) / IQ_SCALE
    p_i = jnp.mean(fi * fi)
    p_q = jnp.mean(fq * fq)
    power = p_i + p_q

    def byte_frac(pred_i, pred_q):
        """Fraction over ALL bytes (analyzer.go scans byte-by-byte)."""
        return 0.5 * (jnp.mean(pred_i) + jnp.mean(pred_q))

    clip = byte_frac(
        (i_u8 == 0) | (i_u8 == 255), (q_u8 == 0) | (q_u8 == 255)
    )
    mag2 = fi * fi + fq * fq
    overload = jnp.mean(mag2 > 0.81)  # |x| > 0.9
    dead = byte_frac(
        jnp.abs(i_bytes - IQ_CENTER) < 1.5,
        jnp.abs(q_bytes - IQ_CENTER) < 1.5,
    )
    x = C(fi, fq)
    snr_db, _, _ = spectral_snr(x, nfft=nfft)
    return (
        snr_db,
        power,
        jnp.sqrt(power),
        dc_i,
        dc_q,
        10.0 * jnp.log10(jnp.maximum(p_i, 1e-30) / jnp.maximum(p_q, 1e-30)),
        clip,
        overload,
        dead,
        jnp.minimum(jnp.min(i_u8), jnp.min(q_u8)).astype(jnp.uint8),
        jnp.maximum(jnp.max(i_u8), jnp.max(q_u8)).astype(jnp.uint8),
    )


def analyze_block_bytes(raw: np.ndarray, nfft: int = 8192) -> BlockStats:
    """Analyze one block's raw interleaved u8 bytes."""
    packed = iq_bytes_as_u16(np.ascontiguousarray(raw))
    vals = _block_metrics(jnp.asarray(packed), nfft=nfft)
    (snr, power, rms, dci, dcq, imb, clip, ovl, dead, mn, mx) = [
        v.item() for v in vals
    ]
    return BlockStats(
        snr_db=snr,
        power=power,
        rms=rms,
        dc_offset_i=dci,
        dc_offset_q=dcq,
        iq_imbalance_db=imb,
        clip_fraction=clip,
        overload_fraction=ovl,
        dead_fraction=dead,
        min_byte=int(mn),
        max_byte=int(mx),
    )


@dataclasses.dataclass
class SignalAnalysis:
    """Full dual-frequency capture analysis (REF vs TGT separately,
    analyzer.go:84-128)."""

    ref: BlockStats
    tgt: BlockStats
    path: str = ""

    @property
    def suitable(self) -> bool:
        ok, _ = assess_tdoa_suitability(self)
        return ok


def analyze_capture(
    path: str, nfft: int = 8192, max_samples_per_block: int = 1 << 21
) -> SignalAnalysis:
    """Analyze a ``.dat`` file: block 1+3 = REF, block 2 = TGT.

    ``max_samples_per_block`` bounds work like the fast analyzer's 32768
    cap (fast_analyzer.go) while defaulting far higher since the device
    pass is cheap.
    """
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n = len(raw) // (2 * NUM_BLOCKS) * 2  # bytes per block
    take = min(n, 2 * max_samples_per_block)
    # REF really is both bracketing blocks (analyzer.go:116-121 semantics):
    # a retune glitch or gain fault confined to the SECOND REF block must
    # show in the verdict, so sample half the budget from each.
    # Even byte count (whole IQ pairs), at least one pair per block so
    # tiny-but-valid captures stay analyzable.
    half = max(take // 2 // 2 * 2, 2 if take >= 2 else 0)
    ref_bytes = np.ascontiguousarray(
        np.concatenate([raw[:half], raw[2 * n : 2 * n + half]])
    )
    tgt_bytes = np.ascontiguousarray(raw[n : n + take])
    return SignalAnalysis(
        ref=analyze_block_bytes(ref_bytes, nfft=nfft),
        tgt=analyze_block_bytes(tgt_bytes, nfft=nfft),
        path=path,
    )


def assess_tdoa_suitability(a: SignalAnalysis) -> Tuple[bool, List[str]]:
    """TDOA-suitability verdict (analyzer.go:460-471 + snr_analysis.go
    tiers: ≥15 dB usable, ≥20 dB precise, ≥25 dB sub-sample)."""
    problems: List[str] = []
    for name, blk in (("REF", a.ref), ("TGT", a.tgt)):
        if blk.is_dead:
            problems.append(f"{name}: receiver appears dead (all-center bytes)")
        if blk.is_clipping:
            problems.append(
                f"{name}: ADC clipping ({blk.clip_fraction*100:.2f}% of bytes)"
            )
        if blk.is_overloaded:
            problems.append(f"{name}: overloaded (reduce gain)")
        if blk.snr_db < 15.0:
            problems.append(
                f"{name}: SNR {blk.snr_db:.1f} dB below the 15 dB correlation floor"
            )
    return (not problems), problems


def generate_recommendations(a: SignalAnalysis) -> List[str]:
    """Human-readable gain/hardware/collection advice
    (analyzer.go:379-629 capability)."""
    recs: List[str] = []
    for name, blk in (("REF", a.ref), ("TGT", a.tgt)):
        g = f"[{name}]"
        if blk.is_dead:
            recs.append(f"{g} No signal: check antenna, frequency, and device.")
            continue
        if blk.is_clipping or blk.is_overloaded:
            recs.append(f"{g} Reduce gain: signal is clipping/overloading the ADC.")
        elif blk.snr_db < 15.0:
            recs.append(
                f"{g} Increase gain or improve antenna: SNR {blk.snr_db:.1f} dB "
                f"< 15 dB minimum for correlation."
            )
        elif blk.snr_db < 25.0:
            recs.append(
                f"{g} Usable ({blk.snr_db:.1f} dB); ≥25 dB recommended for "
                f"sub-sample TDOA precision."
            )
        else:
            recs.append(f"{g} Good: SNR {blk.snr_db:.1f} dB.")
        if abs(blk.dc_offset_i) > 5 or abs(blk.dc_offset_q) > 5:
            recs.append(
                f"{g} Large DC offset (I {blk.dc_offset_i:+.1f}, "
                f"Q {blk.dc_offset_q:+.1f} bytes): enable offset tuning or "
                f"check the tuner."
            )
        if abs(blk.iq_imbalance_db) > 3:
            recs.append(
                f"{g} I/Q imbalance {blk.iq_imbalance_db:+.1f} dB: hardware issue."
            )
    return recs


def _issue_count(b: BlockStats) -> int:
    """Quality-issue tally (analyzer.go:450-458 countQualityIssues)."""
    issues = 0
    issues += b.is_clipping
    issues += b.is_overloaded
    issues += b.is_dead
    issues += b.is_noisy
    issues += (max(abs(b.dc_offset_i), abs(b.dc_offset_q)) > 10.0)
    issues += (abs(b.iq_imbalance_db) > 0.9)  # ≈ the 0.1 linear ratio
    return int(issues)


def compare_signals(a: SignalAnalysis) -> List[str]:
    """REF-vs-TGT balance narrative (analyzer.go:398-448
    compareSignals): SNR balance with gain advice, issue-count
    comparison, and the joint EXCELLENT/POOR/MARGINAL verdict."""
    lines: List[str] = []
    r, t = a.ref, a.tgt
    lines.append(f"SNR: reference {r.snr_db:.1f} dB, target {t.snr_db:.1f} dB")
    if r.snr_db > t.snr_db + 10:
        lines.append("reference significantly stronger — consider "
                     "reducing reference gain")
    elif t.snr_db > r.snr_db + 10:
        lines.append("target significantly stronger — consider "
                     "reducing target gain")
    else:
        lines.append("signal levels reasonably balanced")
    ri, ti = _issue_count(r), _issue_count(t)
    lines.append(f"quality issues: reference {ri}, target {ti}")
    if ri == 0 and ti == 0:
        lines.append("both signals appear suitable for TDOA processing")
    elif ri > ti:
        lines.append("reference signal needs more attention")
    elif ti > ri:
        lines.append("target signal needs more attention")
    ok_r = not (r.is_clipping or r.is_overloaded or r.is_dead
                or r.snr_db < 15.0)
    ok_t = not (t.is_clipping or t.is_overloaded or t.is_dead
                or t.snr_db < 15.0)
    if ok_r and ok_t:
        lines.append("verdict: EXCELLENT — both signals suitable for "
                     "TDOA correlation")
    elif not ok_r and not ok_t:
        lines.append("verdict: POOR — both signals need improvement")
    elif not ok_r:
        lines.append("verdict: MARGINAL — reference signal needs "
                     "improvement")
    else:
        lines.append("verdict: MARGINAL — target signal needs "
                     "improvement")
    return lines


def fast_csv_line(a: SignalAnalysis) -> str:
    """Machine-readable calibrator interface (fast_analyzer.go:44-50):
    ``REF,snr,power,clip,ovl`` then ``TGT,...``."""
    lines = []
    for name, blk in (("REF", a.ref), ("TGT", a.tgt)):
        lines.append(
            f"{name},{blk.snr_db:.2f},{blk.power:.6e},"
            f"{blk.clip_fraction:.6f},{blk.overload_fraction:.6f}"
        )
    return "\n".join(lines)
