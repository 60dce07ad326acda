"""Overlapped capture ingest: host→device transfer pipelined with the
streaming accumulator, so capture→fix costs ≈ max(transfer, compute).

The batch path (cli/processor.py → process_captures) is
transfer-THEN-compute: the whole 1.2 GB capture crosses the link before
the first segment is correlated, so the full path costs
transfer + compute. This module streams the capture in chunks through a
two-deep software pipeline:

    dispatch decode+accumulate(chunk k)      (async — returns at once)
    device_put(chunk k+1)                    (the link streams while
                                              the chip works on k)

The accumulate dispatch is non-blocking, so the device correlates chunk
k while the host pushes chunk k+1's bytes; nothing synchronizes until
the finalize. On any link — PCIe or a slower network-attached one — the
wall time converges to max(total transfer, total compute) + one chunk +
finalize, instead of their sum.

Built on the checkpointable streaming accumulator
(pipeline/streaming.py): each chunk updates three logical blocks at
once by stacking [REF1|TGT|REF2] slices of every station into one
[3·n_st, chunk] signal with per-block pair offsets — one dispatch per
chunk, exactly the batch pipeline's layout
(pipeline/processor.py process_blocks). DC removal is per chunk (the
streaming equivalent of the batch per-block mean subtraction). The
finalize reuses the accumulator's estimator ladder and applies the same
dual-REF clock correction as process_blocks.

Replaces nothing in the reference — its processor loads whole files
into RAM and has no overlap anywhere (processor.go:166-205).
"""

from __future__ import annotations

import functools
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

# Patchable seams for the link-adaptation tests: all host→device puts
# and all wall-clock reads the adaptive planner uses go through these,
# so a test can simulate a slow/pathological link deterministically
# without touching the device.
_device_put = jax.device_put
_now = time.monotonic

from tdoa_tpu.io.datfile import u16_to_iq_planar
from tdoa_tpu.ops.cplx import C
from tdoa_tpu.ops.corr import clock_correct_blocks, resolve_seg
from tdoa_tpu.pipeline.streaming import (
    AccState,
    acc_finalize,
    acc_init,
    acc_update,
)
from tdoa_tpu.utils.constants import DEFAULT_MAX_LAG


@functools.partial(
    jax.jit, static_argnames=("seg_len", "fft_len"), donate_argnums=(0,),
)
def _decode_update(
    state: AccState,
    packed: jax.Array,  # [rows, L] u16-packed I/Q words
    pair_idx: jax.Array,
    seg_len: int,
    fft_len: int,
) -> AccState:
    """u16 decode + DC removal + accumulate fused into ONE dispatch per
    chunk: the per-chunk host dispatch cost bounds how closely the
    overlapped path can hug max(transfer, compute). The accumulator
    state is donated — the ~10 [m, F] float32 banks update in place
    instead of reallocating every chunk."""
    return acc_update(
        state, u16_to_iq_planar(packed), pair_idx, seg_len, fft_len,
        remove_dc=True,
    )


def plan_chunks(
    block_len: int, seg_len: int, chunk_samples: Optional[int] = None
) -> Tuple[int, List[Tuple[int, int]]]:
    """Chunk layout for one block axis: (chunk, [(start, length), ...]).

    Every chunk length is a multiple of ``seg_len`` (the accumulator's
    contract); the ragged tail past the last whole segment is dropped,
    exactly like the batch correlator's segmentation. A smaller final
    chunk keeps every whole segment in play.
    """
    if chunk_samples is None:
        # ~48 segments per chunk: large enough that the per-chunk
        # dispatch amortizes, small enough that the ramp-in chunk and
        # the pipeline's storage stay a small fraction of the capture.
        # Sized on an earlier accelerator host behind a slow network
        # link (16-segment chunks cost 1.33x max(transfer, compute),
        # 48-segment chunks 1.05x); not re-measured on the H100.
        chunk_samples = 48 * seg_len
    chunk = max(chunk_samples // seg_len, 1) * seg_len
    usable = (block_len // seg_len) * seg_len
    spans = []
    pos = 0
    while pos < usable:
        n = min(chunk, usable - pos)
        n = (n // seg_len) * seg_len
        if n == 0:
            break
        spans.append((pos, n))
        pos += n
    return chunk, spans


# ---- runtime link adaptation ----
#
# With fixed chunk geometry the overlapped path inherits whatever state
# the host→device link is in: a slow link with a high per-call dispatch
# cost makes per-chunk overhead dominate, and a link whose small puts
# stream far slower than one large put makes chunking itself the
# bottleneck. Neither state is knowable before the run, so the plan
# comes from measurement: the first chunk's observed MB/s plus the
# dispatch round-trip.
#
# Every threshold below was sized from measurements on an earlier
# deployment whose accelerator sat behind a slow network link (healthy
# chunked rates 19-34 MB/s, ~30 ms dispatch round-trips, and one
# per-put pathology at 1.8 MB/s where a single large put streamed
# >20 MB/s). They are not H100 numbers: on an H100 host's PCIe link
# (about 17 GB/s) the monolithic probe and fallback never trigger and
# the ladder stays at its first rung.

# Chunk-size ladder (segments per chunk). A small fixed ladder — not a
# continuum — so the decode+accumulate program shapes stay cacheable
# across runs (each size is one XLA executable, persisted by the
# compilation cache).
CHUNK_LADDER_SEGS = (48, 96, 192)
# Below this observed first-chunk rate, pay one extra mid-size put to
# probe the monolithic rate (between the slow link's healthy 19 MB/s
# and its 1.8 MB/s pathology).
MONO_PROBE_FLOOR_MBPS = 8.0
# Fall back to monolithic transfer when it streams this much faster
# than the chunked path (the pathology measured >10x).
MONO_FALLBACK_RATIO = 2.5
# Mid-stream degradation trigger: consecutive chunks at a small
# fraction of the best observed rate.
DEGRADE_RATIO = 0.25
DEGRADE_CONSECUTIVE = 2


def choose_chunk_segs(
    rate_bytes_per_s: float,
    dispatch_rt_s: float,
    row_set_bytes_per_seg: int,
    ladder: Sequence[int] = CHUNK_LADDER_SEGS,
) -> int:
    """Pick the smallest ladder size whose per-chunk transfer time
    keeps the fixed per-chunk pipeline overhead (~2 host dispatch
    round-trips of bookkeeping: the accumulate dispatch plus the next
    put's setup) under ~5%: chunk_time ≥ 40 × dispatch_rt. A fast link
    with a sub-millisecond round-trip keeps 48 segments; a slow
    round-trip escalates to 96/192.

    ``row_set_bytes_per_seg`` is the bytes one segment contributes
    across every streamed row (3·n_st rows × seg_len × 2 B u16)."""
    if (rate_bytes_per_s <= 0 or row_set_bytes_per_seg <= 0
            or dispatch_rt_s <= 0):
        return ladder[0]
    target_s = 40.0 * dispatch_rt_s
    for segs in ladder:
        if segs * row_set_bytes_per_seg / rate_bytes_per_s >= target_s:
            return segs
    return ladder[-1]


def should_fallback_monolithic(
    rate_chunked_bps: float, rate_mono_bps: float
) -> bool:
    """Monolithic transfer wins when the per-put overhead pathology
    makes chunked streaming a small fraction of the link's real rate."""
    return rate_mono_bps > MONO_FALLBACK_RATIO * max(rate_chunked_bps, 1e-9)


def _measure_dispatch_rt() -> float:
    """One tiny jit dispatch + scalar sync: the per-call host↔device
    round-trip floor the chunk-size target is scaled by. Median of 3
    (the first may hit a compile-cache lookup)."""
    f = jax.jit(lambda v: v + 1.0)
    tiny = jnp.zeros((8,), jnp.float32)
    jax.block_until_ready(f(tiny))
    ts = []
    for _ in range(3):
        t0 = _now()
        jax.block_until_ready(f(tiny))
        ts.append(_now() - t0)
    ts.sort()
    return ts[1]


@functools.partial(jax.jit, static_argnames=("length", "block_lens"))
def _gather_chunk_rows_device(
    dev_u16: Tuple[jax.Array, ...],
    start: jax.Array,  # scalar within-block offset
    length: int,
    block_lens: Tuple[int, ...],
) -> jax.Array:
    """[3·n_st, length] u16 chunk rows gathered ON DEVICE from each
    station's full resident capture array — the monolithic-fallback
    counterpart of the host-side ``host_chunk`` gather."""
    rows = []
    for b in range(3):
        for s, v in enumerate(dev_u16):
            o = b * block_lens[s] + start
            rows.append(jax.lax.dynamic_slice(v, (o,), (length,)))
    return jnp.stack(rows)


def _chunk_lengths(block_len: int, seg_len: int) -> List[int]:
    """Every chunk length a plan over ``block_len`` can dispatch: each
    ladder size and the ragged final chunk it leaves, from the block
    start and from the end of a first default-size chunk (where a
    runtime re-plan resumes)."""
    usable = (block_len // seg_len) * seg_len
    first = min(CHUNK_LADDER_SEGS[0] * seg_len, usable)
    out = set()
    for segs in CHUNK_LADDER_SEGS:
        cn = segs * seg_len
        for start in {0, first}:
            rest = usable - start
            if rest <= 0:
                continue
            out.add(min(cn, rest))
            if rest > cn and rest % cn:
                out.add(rest % cn)
    return sorted(out)


def warm_ingest_programs(
    n_rows: int,
    pair_idx: np.ndarray,
    *,
    block_len: int,
    seg_len: int,
    fft_len: int,
) -> int:
    """Run the decode+accumulate program once, on device zeros, for
    every chunk length a plan over ``block_len`` can dispatch (each
    ladder size and its ragged tail), so neither the first chunk nor a
    runtime chunk-size adaptation pays a compile mid-stream. Returns
    the number of chunk lengths warmed."""
    pair_dev = jnp.asarray(np.asarray(pair_idx, np.int32))
    m = int(pair_dev.shape[0])
    lengths = _chunk_lengths(block_len, seg_len)
    for n in lengths:
        state = acc_init(n_rows, m, fft_len)
        rows = jnp.zeros((n_rows, n), jnp.uint16)
        jax.block_until_ready(
            _decode_update(state, rows, pair_dev, seg_len, fft_len)
        )
    return len(lengths)


class TailIngest:
    """Incremental overlapped ingest of a GROWING capture window — the
    stream service's counterpart of ``ingest_overlapped``.

    A collection takes 10–100 s to write its ``.dat`` files;
    ``ingest_overlapped`` (and the batch path) only start after the
    last byte lands, so the fix trails window close by transfer +
    compute. This session consumes the files WHILE they grow: each
    ``feed`` call streams every newly-available chunk to the device,
    so by the time the writers close, only the final chunks and the
    finalize remain — the fix lands ~immediately at window close.

    Differences from ``ingest_overlapped``'s layout, chosen for
    tail-following: three per-block accumulators instead of one
    stacked [REF1|TGT|REF2] state. A stacked chunk needs the same
    within-block offset in all three blocks — available only once the
    file is 2/3 written — while per-block states stream block 1 during
    its own capture. Per block the accumulated math is identical
    (same spans, same per-chunk slot rotation, same per-chunk DC
    removal), so the finalize reproduces ``ingest_overlapped`` /
    ``process_blocks`` numerics to the usual streaming tolerance
    (pinned by tests/test_ingest.py).

    The reference's workflow is capture → scp → process
    (docs/usage.md:139-150); it has no streaming anywhere.

    Chunk readiness: chunk ``(b, start, len)`` needs bytes up to
    ``b·block_len_s + start + len`` in EVERY station's file (stations
    capture in lockstep, so availability tracks the slowest writer).
    ``block_len`` — the final per-block sample count — must be known
    up front (the service knows the collection duration); a station
    whose finished file disagrees invalidates the session
    (``mismatch``), and the caller falls back to the batch path.
    """

    def __init__(
        self,
        station_names: Sequence[str],
        pair_idx: np.ndarray,  # [m, 2]
        ref_geo_tdoa: np.ndarray,  # [m] samples
        *,
        block_len: int,
        capture_block_len: Optional[int] = None,
        max_lag: int = DEFAULT_MAX_LAG,
        seg_len: Optional[int] = None,
        weighting: str = "ht",
        clock_correction: bool = True,
        chunk_samples: Optional[int] = None,
        adaptive: bool = True,
    ):
        self.names = list(station_names)
        n_st = len(self.names)
        self.block_len = int(block_len)
        # Files' actual per-block length (>= the ANALYZED block_len,
        # e.g. under truncate_samples): block b of every station sits
        # at b·capture_block_len regardless of how much is analyzed.
        self.capture_block_len = int(
            capture_block_len if capture_block_len is not None
            else block_len
        )
        if self.capture_block_len < self.block_len:
            raise ValueError(
                "capture_block_len must be >= the analyzed block_len"
            )
        self.max_lag = max_lag
        self.weighting = weighting
        self.clock_correction = clock_correction
        self._pair_np = np.asarray(pair_idx, np.int32)
        self._m = int(self._pair_np.shape[0])
        self._ref_geo = np.asarray(ref_geo_tdoa)

        want = seg_len if seg_len is not None else 1 << 16
        self._seg, self._fft_len = resolve_seg(
            self.block_len, max_lag, want, None
        )
        chunk, spans = plan_chunks(
            self.block_len, self._seg, chunk_samples
        )
        if not spans:
            raise ValueError(
                f"block length {self.block_len} holds no whole segment "
                f"(seg_len={self._seg})"
            )
        # Capture-order chunk plan: (block, start, length). A flat list
        # (not 3×spans arithmetic) so the link adaptation can re-plan
        # the UNDISPATCHED remainder at a different chunk size.
        self._plan: List[Tuple[int, int, int]] = [
            (b, s, l) for b in range(3) for (s, l) in spans
        ]
        # Adaptation active only when the caller didn't pin the
        # geometry and the plan is long enough to matter.
        self._adaptive = bool(adaptive and chunk_samples is None
                              and len(self._plan) >= 4)
        self._retuned = not self._adaptive
        self.link_diag: dict = {
            "adaptive": self._adaptive,
            "chunk_segs": chunk // self._seg,
        }
        self._pair_dev = jnp.asarray(self._pair_np)
        n_st = len(self.names)
        self._states = [
            acc_init(n_st, self._m, self._fft_len) for _ in range(3)
        ]
        self._next = 0  # cursor over the plan, capture order
        self.mismatch: Optional[str] = None

    def warm(self) -> int:
        """Compile every chunk program this session can dispatch; see
        :func:`warm_ingest_programs`."""
        return warm_ingest_programs(
            len(self.names), self._pair_np, block_len=self.block_len,
            seg_len=self._seg, fft_len=self._fft_len,
        )

    @property
    def total_chunks(self) -> int:
        return len(self._plan)

    @property
    def chunks_dispatched(self) -> int:
        return self._next

    @property
    def complete(self) -> bool:
        return self._next >= self.total_chunks

    def _chunk(self, c: int):
        b, s, l = self._plan[c]
        return b, (s, l)

    def _retune_plan(self, rate_bytes_per_s: float) -> None:
        """One-shot chunk-size re-plan from the first chunk's measured
        put rate (same ladder rule as ingest_overlapped). Only the
        undispatched remainder is re-planned; consumed chunks are
        already in the accumulators."""
        self._retuned = True
        dispatch_rt = _measure_dispatch_rt()
        n_st = len(self.names)
        segs = choose_chunk_segs(
            rate_bytes_per_s, dispatch_rt, n_st * self._seg * 2
        )
        self.link_diag.update(
            dispatch_rt_s=round(dispatch_rt, 4),
            first_chunk_rate_mbps=round(rate_bytes_per_s / 1e6, 2),
            chunk_segs=segs,
        )
        cur_segs = self._plan[0][2] // self._seg if self._plan else 0
        if segs == cur_segs:
            return
        done = self._plan[: self._next]
        pos = {0: 0, 1: 0, 2: 0}
        for b, s, l in done:
            pos[b] = max(pos[b], s + l)
        usable = (self.block_len // self._seg) * self._seg
        cn = segs * self._seg
        rest: List[Tuple[int, int, int]] = []
        for b in range(3):
            p = pos[b]
            while p < usable:
                n = min(cn, usable - p)
                n = (n // self._seg) * self._seg
                if n == 0:
                    break
                rest.append((b, p, n))
                p += n
        self._plan = done + rest

    def feed(self, host_u16: Sequence[np.ndarray]) -> int:
        """Stream every chunk whose bytes all stations already have.

        ``host_u16`` are the stations' CURRENT packed-u16 views (in
        ``station_names`` order) — re-mmap growing files before each
        call; short views simply mean fewer ready chunks. Returns the
        number of chunks dispatched by this call. Dispatches are
        async (device work overlaps the host's next poll/read)."""
        avail = [int(v.shape[0]) for v in host_u16]
        done = 0
        while self._next < self.total_chunks:
            b, (start, length) = self._chunk(self._next)
            off = b * self.capture_block_len + start
            if min(avail) < off + length:
                break
            rows = np.stack([v[off:off + length] for v in host_u16])
            t0 = _now()
            buf = _device_put(rows)
            if not self._retuned:
                # The link probe: wait for the bytes to land, so the
                # rate is the link's and not the enqueue's.
                jax.block_until_ready(buf)
            dt = max(_now() - t0, 1e-9)
            self._states[b] = _decode_update(
                self._states[b], buf, self._pair_dev,
                self._seg, self._fft_len,
            )
            self._next += 1
            done += 1
            if not self._retuned:
                self._retune_plan(rows.nbytes / dt)
        return done

    def check_final_sizes(self, final_u16: Sequence[int]) -> bool:
        """Validate the finished files against the session's assumed
        block length: each station's ACTUAL per-block sample count
        (``final // 3``, the .dat contract's 3 equal blocks) must equal
        the session's — a shorter file means block-1/2 chunks were
        never readable, and a LONGER file means its real block
        boundaries sit past the assumed ones, so every block-1/2 chunk
        the session streamed mixed two blocks. Sets ``mismatch`` and
        returns False on violation — the caller must discard the
        session and batch-process the window instead."""
        for name, n in zip(self.names, final_u16):
            if int(n) // 3 != self.capture_block_len:
                self.mismatch = (
                    f"{name}: final capture holds {int(n) // 3} samples"
                    f"/block, session assumed {self.capture_block_len}"
                )
                return False
        return True

    def finalize(self, host_u16: Sequence[np.ndarray]):
        """Drain any remaining chunks from the (now complete) views and
        produce the ``process_blocks`` 10-tuple."""
        self.feed(host_u16)
        if not self.complete:
            b, s, l = self._plan[-1]
            raise ValueError(
                f"capture incomplete: {self._next}/{self.total_chunks} "
                f"chunks available (the last chunk needs "
                f"{b * self.capture_block_len + s + l} "
                f"samples per station)"
            )
        m = self._m
        res = [
            acc_finalize(self._states[b], self._pair_dev, self.max_lag,
                         weighting=self.weighting, fft_len=self._fft_len)
            for b in range(3)
        ]

        def stk(field):
            return jnp.stack([getattr(r, field) for r in res])

        return clock_correct_blocks(
            stk("delay").reshape(3, m),
            stk("delay_std").reshape(3, m),
            stk("quality").reshape(3, m),
            stk("peak_value").reshape(3, m),
            stk("corr").reshape(3, m, -1),
            stk("corr_re").reshape(3, m, -1),
            stk("corr_im").reshape(3, m, -1),
            jnp.asarray(self._ref_geo, jnp.float32),
            self.clock_correction,
        )


def ingest_overlapped(
    host_u16: Sequence[np.ndarray],  # per station: [3·block_len] packed u16
    pair_idx: np.ndarray,  # [m, 2] station pairs
    ref_geo_tdoa: np.ndarray,  # [m] REF-tx geometric TDOA, samples
    *,
    block_len: int,
    block_lens: Optional[Sequence[int]] = None,
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "ht",
    clock_correction: bool = True,
    chunk_samples: Optional[int] = None,
    adaptive: bool = True,
    diag: Optional[dict] = None,
):
    """Stream a 3-block capture from host memory to corrected TDOAs with
    transfer/compute overlap. Returns the same 10-tuple as
    ``process_blocks`` (corrected, tgt_delay, ref_delays[m,2], clock,
    quality[3,m], peaks[3,m], corrected_std, tgt_corr_window, tgt_std,
    block_corr_windows_complex[2,3,m,W]).

    ``host_u16`` is each station's packed-u16 view of its capture bytes
    (io.datfile.iq_bytes_as_u16 — zero-copy from the raw .dat mmap).
    ``block_len`` is the ANALYZED per-block sample count (common across
    stations); ``block_lens`` gives each station's own capture block
    length when files differ in size (its blocks sit at multiples of
    its own length), defaulting to ``block_len`` everywhere.

    ``adaptive`` (default on; disabled when ``chunk_samples`` pins the
    geometry) measures the link at runtime — the first chunk's observed
    MB/s plus the dispatch round-trip — then (a) re-plans the remaining
    chunks to a ladder size that keeps per-chunk overhead ≤ ~5%, and
    (b) falls back to ONE monolithic put per station + on-device chunk
    gathers when chunked puts run far slower than one large put.
    ``diag``, when given, is
    filled with the decisions (mode, rates, chosen chunk size).
    """
    n_st = len(host_u16)
    if block_lens is None:
        block_lens = [block_len] * n_st
    if min(block_lens) < block_len:
        raise ValueError("block_lens must each be >= the analyzed "
                         "block_len")
    m = int(np.asarray(pair_idx).shape[0])
    pair_np = np.asarray(pair_idx, np.int32)

    want = seg_len if seg_len is not None else 1 << 16
    seg_r, fft_len = resolve_seg(block_len, max_lag, want, None)

    # Stacked pair list over the 3 logical blocks.
    offsets = np.arange(3, dtype=np.int32)[:, None, None] * n_st
    all_pairs = jnp.asarray(
        (pair_np[None, :, :] + offsets).reshape(3 * m, 2)
    )

    chunk, spans = plan_chunks(block_len, seg_r, chunk_samples)
    if not spans:
        raise ValueError(
            f"block length {block_len} holds no whole segment "
            f"(seg_len={seg_r})"
        )

    def host_chunk(start: int, length: int) -> np.ndarray:
        """[3·n_st, length] u16: every station's three block slices at
        the same within-block offset (one host gather per chunk)."""
        rows = []
        for b in range(3):
            for s in range(n_st):
                o = b * block_lens[s] + start
                rows.append(host_u16[s][o : o + length])
        return np.stack(rows)

    state = acc_init(3 * n_st, 3 * m, fft_len)

    def update(st, rows_buf):
        return _decode_update(st, rows_buf, all_pairs, seg_r, fft_len)

    usable = (block_len // seg_r) * seg_r

    def plan_from(pos0: int, segs: int) -> List[Tuple[int, int]]:
        out = []
        p = pos0
        cn = segs * seg_r
        while p < usable:
            n = min(cn, usable - p)
            n = (n // seg_r) * seg_r
            if n == 0:
                break
            out.append((p, n))
            p += n
        return out

    diag_out = diag if diag is not None else {}
    adaptive_on = bool(adaptive and chunk_samples is None
                       and len(spans) >= 4)
    row_set_bytes = 3 * n_st * seg_r * 2  # u16 bytes/segment, all rows
    diag_out.update(
        adaptive=adaptive_on, mode="chunked", chunk_segs=chunk // seg_r,
        fallback_reason=None,
    )

    dispatch_rt = _measure_dispatch_rt() if adaptive_on else 0.0

    # First chunk: timed put + one scalar sync — the link probe.
    t0 = _now()
    buf = _device_put(host_chunk(*spans[0]))
    dt0 = max(_now() - t0, 1e-9)
    mono = False
    if adaptive_on:
        jax.block_until_ready(buf)
        dt0 = max(_now() - t0, 1e-9)
        rate0 = 3 * n_st * spans[0][1] * 2 / dt0
        diag_out["dispatch_rt_s"] = round(dispatch_rt, 4)
        diag_out["first_chunk_rate_mbps"] = round(rate0 / 1e6, 2)
        if rate0 < MONO_PROBE_FLOOR_MBPS * 1e6:
            # Suspiciously slow chunked put: pay one mid-size
            # contiguous put to see the link's monolithic rate.
            pe = int(min(16 << 20, host_u16[0].shape[0]))
            t0 = _now()
            pb = _device_put(np.ascontiguousarray(host_u16[0][:pe]))
            jax.block_until_ready(pb)
            rate_m = pe * 2 / max(_now() - t0, 1e-9)
            del pb
            diag_out["mono_probe_rate_mbps"] = round(rate_m / 1e6, 2)
            mono = should_fallback_monolithic(rate0, rate_m)
            if mono:
                diag_out["fallback_reason"] = "probe"
        if not mono:
            segs_pick = choose_chunk_segs(rate0, dispatch_rt,
                                          row_set_bytes)
            diag_out["chunk_segs"] = segs_pick
            if segs_pick * seg_r != chunk:
                spans = [spans[0]] + plan_from(
                    spans[0][0] + spans[0][1], segs_pick
                )

    # Two-deep pipeline: the accumulate dispatch for the buffered chunk
    # is issued BEFORE the next device_put, so the (blocking) host→
    # device stream of chunk k+1 overlaps the device's work on chunk k.
    state = update(state, buf)
    # Within-run transfer floor: the summed host-side put times — the
    # same link state the stream itself saw, unlike a transfer probe
    # timed separately.
    put_s = dt0
    best_rate = 0.0
    degrade_run = 0
    k = 1
    while not mono and k < len(spans):
        start, length = spans[k]
        t0 = _now()
        buf = _device_put(host_chunk(start, length))
        dt = max(_now() - t0, 1e-9)
        put_s += dt
        state = update(state, buf)  # async; overlaps the next put
        k += 1
        if adaptive_on:
            rate = 3 * n_st * length * 2 / dt
            best_rate = max(best_rate, rate)
            slow = (rate < DEGRADE_RATIO * best_rate
                    and rate < MONO_PROBE_FLOOR_MBPS * 1e6)
            degrade_run = degrade_run + 1 if slow else 0
            if (degrade_run >= DEGRADE_CONSECUTIVE
                    and len(spans) - k >= 3):
                mono = True
                diag_out["fallback_reason"] = "degradation"

    diag_out["transfer_stream_s"] = round(put_s, 3)

    if mono and k < len(spans):
        # Monolithic remainder: one put per station of its FULL capture
        # array (the couple already-consumed chunks ride along — far
        # cheaper than per-chunk puts in this link state), then big
        # on-device chunk gathers feed the same accumulator.
        diag_out["mode"] = "monolithic-fallback"
        t0 = _now()
        dev_full = tuple(
            _device_put(np.ascontiguousarray(v)) for v in host_u16
        )
        jax.block_until_ready(dev_full)
        diag_out["mono_transfer_s"] = round(_now() - t0, 3)
        diag_out["transfer_stream_s"] = round(
            put_s + (_now() - t0), 3)
        rest = plan_from(spans[k][0], CHUNK_LADDER_SEGS[-1])
        bl_static = tuple(int(b) for b in block_lens)
        for start, length in rest:
            rows = _gather_chunk_rows_device(
                dev_full, jnp.int32(start), length, bl_static
            )
            state = update(state, rows)
        del dev_full

    res = acc_finalize(state, all_pairs, max_lag, weighting=weighting,
                       fft_len=fft_len)

    return clock_correct_blocks(
        res.delay.reshape(3, m),
        res.delay_std.reshape(3, m),
        res.quality.reshape(3, m),
        res.peak_value.reshape(3, m),
        res.corr.reshape(3, m, -1),
        res.corr_re.reshape(3, m, -1),
        res.corr_im.reshape(3, m, -1),
        jnp.asarray(np.asarray(ref_geo_tdoa), jnp.float32),
        clock_correction,
    )
