"""Overlapped chunked ingest (pipeline/ingest.py): the streamed
host→device path must reproduce the batch pipeline's TDOAs and fix.

The overlap itself (transfer during compute) is a wall-clock property
measured on hardware by bench.py; these tests pin the NUMERICS — chunk
boundaries, per-chunk DC removal, the stacked 3-block pair layout, the
clock correction, and the CLI wiring — on the CPU backend.
"""

import numpy as np
import pytest

from tdoa_tpu.geo import lla_to_enu
from tdoa_tpu.pipeline import TDOAProcessor
from tdoa_tpu.sim import SimScene, simulate_scene, write_scene_captures

BLOCK = 1 << 17


def _scene(omaha, **kw):
    return SimScene(
        station_names=omaha["names"],
        station_lla=omaha["station_lla"],
        ref_tx_lla=omaha["ref_tx_lla"],
        tgt_tx_lla=omaha["tgt_tx_lla"],
        ref_freq=omaha["ref_freq"],
        tgt_freq=omaha["tgt_freq"],
        block_len=BLOCK,
        **kw,
    )


def _fix_error_m(fix, tgt_lla):
    est = np.array([fix.lat, fix.lon, tgt_lla[2]])
    return np.linalg.norm(lla_to_enu(est, tgt_lla)[:2])


def test_plan_chunks_covers_whole_segments():
    from tdoa_tpu.pipeline.ingest import plan_chunks

    chunk, spans = plan_chunks(block_len=10_000, seg_len=896,
                               chunk_samples=3 * 896)
    assert chunk == 3 * 896
    # Every span a multiple of seg_len, contiguous, covering 11*896.
    assert all(n % 896 == 0 for _, n in spans)
    assert spans[0][0] == 0
    for (s0, n0), (s1, _) in zip(spans, spans[1:]):
        assert s1 == s0 + n0
    assert sum(n for _, n in spans) == (10_000 // 896) * 896


def test_choose_chunk_segs_ladder():
    """Chunk-size rule (round-4 verdict item 4): per-chunk transfer
    time must cover ≥ 40 dispatch round-trips (floored at 1 s) so the
    fixed per-chunk pipeline overhead stays ≤ ~5%."""
    from tdoa_tpu.pipeline.ingest import choose_chunk_segs

    row = 9 * 45056 * 2  # 3 stations stacked over 3 blocks, u16
    # Healthy link + healthy dispatch: 48 segs ≈ 1.56 s/chunk ≥ 1.2 s.
    assert choose_chunk_segs(25e6, 0.03, row) == 48
    # Congested dispatch (0.1 s RT → 4 s target): only 192 segs
    # (≈ 6.2 s/chunk) clears it — the driver-r04 scenario.
    assert choose_chunk_segs(25e6, 0.1, row) == 192
    # Very fast link (short chunks): ladder max, capped.
    assert choose_chunk_segs(500e6, 0.1, row) == 192
    # Degenerate inputs fall back to the default.
    assert choose_chunk_segs(0.0, 0.03, row) == 48


def test_should_fallback_monolithic():
    from tdoa_tpu.pipeline.ingest import should_fallback_monolithic

    # r04 cold-run pathology: chunked 1.8 MB/s vs monolithic >20 MB/s.
    assert should_fallback_monolithic(1.8e6, 20e6)
    # Driver r04: chunked 33.6 MB/s BEAT monolithic 10.8 — never fall
    # back when chunking is the faster strategy.
    assert not should_fallback_monolithic(33.6e6, 10.8e6)
    # Comparable rates: chunking keeps the overlap win.
    assert not should_fallback_monolithic(20e6, 24e6)


def _delay_capture_u16(n_st, block_len, delays, seed=0):
    """Synthetic u16 captures: shared REF noise at zero offset in REF
    blocks, shared TGT noise delayed per station in the TGT block —
    corrected TDOA for pair (i,j) is delays[j]-delays[i] (the
    correlator's lag convention)."""
    from tdoa_tpu.io.datfile import IQ_CENTER, IQ_SCALE

    rng = np.random.default_rng(seed)
    pad = 64  # both-sided: delays may be negative
    ref = (rng.standard_normal(block_len + 2 * pad)
           + 1j * rng.standard_normal(block_len + 2 * pad))
    tgt = (rng.standard_normal(block_len + 2 * pad)
           + 1j * rng.standard_normal(block_len + 2 * pad))
    out = []
    for s in range(n_st):
        d = int(delays[s])
        blocks = [
            ref[pad:pad + block_len],
            tgt[pad - d:pad - d + block_len],
            ref[pad:pad + block_len],
        ]
        z = np.concatenate(blocks) * 0.25
        i = np.clip(np.round(z.real * IQ_SCALE + IQ_CENTER),
                    0, 255).astype(np.uint16)
        q = np.clip(np.round(z.imag * IQ_SCALE + IQ_CENTER),
                    0, 255).astype(np.uint16)
        out.append((i | (q << 8)).astype(np.uint16))
    return out


def test_ingest_adaptive_monolithic_fallback(monkeypatch):
    """With chunked puts simulated at a pathological 1 MB/s against a
    50 MB/s monolithic rate (the r04 cold-run link state), the adaptive
    ingest must probe, fall back to monolithic transfer + on-device
    chunk gathers, and still produce the right TDOAs."""
    from tdoa_tpu.pipeline import ingest as ing

    clock = {"t": 0.0}

    def fake_now():
        return clock["t"]

    real_put = ing._device_put

    def fake_put(x):
        arr = np.asarray(x) if not hasattr(x, "nbytes") else x
        if getattr(arr, "ndim", 1) >= 2:
            clock["t"] += arr.nbytes / 1e6   # chunked rows: 1 MB/s
        else:
            clock["t"] += arr.nbytes / 50e6  # contiguous 1-D: 50 MB/s
        return real_put(x)

    monkeypatch.setattr(ing, "_now", fake_now)
    monkeypatch.setattr(ing, "_device_put", fake_put)
    monkeypatch.setattr(ing, "_measure_dispatch_rt", lambda: 0.03)

    seg = 2048
    block_len = 8 * 48 * seg
    delays = [0, 5, -3]
    host = _delay_capture_u16(3, block_len, delays, seed=4)
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    geo = np.zeros(3, np.float32)
    kw = dict(block_len=block_len, max_lag=256, seg_len=seg,
              weighting="ht")
    diag = {}
    out = ing.ingest_overlapped(host, pair, geo, adaptive=True,
                                diag=diag, **kw)
    assert diag["mode"] == "monolithic-fallback"
    assert diag["fallback_reason"] == "probe"
    assert diag["first_chunk_rate_mbps"] < 8.0
    assert diag["mono_probe_rate_mbps"] > 20.0
    want = np.array([delays[j] - delays[i] for i, j in pair], np.float64)
    np.testing.assert_allclose(
        np.asarray(out[0], np.float64), want, atol=0.5)
    # And against the non-adaptive path on the same bytes (chunk
    # partition differs → per-chunk DC removal differs slightly).
    ref = ing.ingest_overlapped(host, pair, geo, adaptive=False, **kw)
    np.testing.assert_allclose(
        np.asarray(out[0]), np.asarray(ref[0]), atol=0.05)


def test_ingest_adaptive_chunk_escalation(monkeypatch):
    """A congested dispatch round-trip (0.1 s) at a healthy link rate
    must escalate the chunk size to the ladder max (fewer chunks →
    less per-chunk overhead: the r04 driver run lost 19% to 29 small
    chunks) while staying in chunked mode."""
    from tdoa_tpu.pipeline import ingest as ing

    clock = {"t": 0.0}
    real_put = ing._device_put

    def fake_put(x):
        arr = np.asarray(x) if not hasattr(x, "nbytes") else x
        clock["t"] += arr.nbytes / 25e6  # healthy 25 MB/s
        return real_put(x)

    monkeypatch.setattr(ing, "_now", lambda: clock["t"])
    monkeypatch.setattr(ing, "_device_put", fake_put)
    monkeypatch.setattr(ing, "_measure_dispatch_rt", lambda: 0.1)

    seg = 2048
    block_len = 8 * 48 * seg
    delays = [0, 5, -3]
    host = _delay_capture_u16(3, block_len, delays, seed=4)
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    geo = np.zeros(3, np.float32)
    kw = dict(block_len=block_len, max_lag=256, seg_len=seg,
              weighting="ht")
    diag = {}
    out = ing.ingest_overlapped(host, pair, geo, adaptive=True,
                                diag=diag, **kw)
    assert diag["mode"] == "chunked"
    assert diag["chunk_segs"] == 192
    want = np.array([delays[j] - delays[i] for i, j in pair], np.float64)
    np.testing.assert_allclose(
        np.asarray(out[0], np.float64), want, atol=0.5)
    ref = ing.ingest_overlapped(host, pair, geo, adaptive=False, **kw)
    np.testing.assert_allclose(
        np.asarray(out[0]), np.asarray(ref[0]), atol=0.05)


def test_ingest_adaptive_healthy_link_keeps_default(monkeypatch):
    """A healthy link + healthy dispatch must keep the measured-optimal
    48-segment chunks AND never trigger the monolithic probe (its extra
    put would waste link time on every healthy run)."""
    from tdoa_tpu.pipeline import ingest as ing

    clock = {"t": 0.0}
    real_put = ing._device_put
    puts_1d = []

    def fake_put(x):
        arr = np.asarray(x) if not hasattr(x, "nbytes") else x
        if getattr(arr, "ndim", 1) >= 2:
            clock["t"] += arr.nbytes / 25e6
        else:
            puts_1d.append(arr.nbytes)
            clock["t"] += arr.nbytes / 25e6
        return real_put(x)

    monkeypatch.setattr(ing, "_now", lambda: clock["t"])
    monkeypatch.setattr(ing, "_device_put", fake_put)
    # A dispatch round-trip small next to this test's per-chunk
    # transfer time: the ladder keeps its smallest size.
    monkeypatch.setattr(ing, "_measure_dispatch_rt", lambda: 0.001)

    seg = 2048
    block_len = 8 * 48 * seg
    host = _delay_capture_u16(3, block_len, [0, 5, -3], seed=4)
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    diag = {}
    ing.ingest_overlapped(
        host, pair, np.zeros(3, np.float32), block_len=block_len,
        max_lag=256, seg_len=seg, weighting="ht", adaptive=True,
        diag=diag,
    )
    assert diag["mode"] == "chunked"
    assert diag["fallback_reason"] is None
    assert "mono_probe_rate_mbps" not in diag
    assert not puts_1d  # no monolithic probe transfer happened


def test_tail_ingest_adaptive_retune(monkeypatch):
    """TailIngest must re-plan its UNDISPATCHED chunks after measuring
    the first chunk's put rate (same ladder rule as ingest_overlapped),
    and the retuned session must reproduce the fixed-plan TDOAs."""
    from tdoa_tpu.pipeline import ingest as ing

    clock = {"t": 0.0}
    real_put = ing._device_put

    def fake_put(x):
        arr = np.asarray(x) if not hasattr(x, "nbytes") else x
        clock["t"] += arr.nbytes / 25e6
        return real_put(x)

    monkeypatch.setattr(ing, "_now", lambda: clock["t"])
    monkeypatch.setattr(ing, "_device_put", fake_put)
    monkeypatch.setattr(ing, "_measure_dispatch_rt", lambda: 0.1)

    seg = 2048
    block_len = 8 * 48 * seg
    delays = [0, 5, -3]
    host = _delay_capture_u16(3, block_len, delays, seed=4)
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    geo = np.zeros(3, np.float32)
    kw = dict(block_len=block_len, max_lag=256, seg_len=seg,
              weighting="ht")

    sess = ing.TailIngest(["a", "b", "c"], pair, geo, adaptive=True,
                          **kw)
    n0 = sess.total_chunks
    # Feed in two growth steps so the retune happens mid-capture.
    half = [v[: v.shape[0] // 2] for v in host]
    sess.feed(half)
    assert sess.link_diag["chunk_segs"] == 192  # escalated (0.1 s RT)
    assert sess.total_chunks < n0  # remainder re-planned to big chunks
    out = sess.finalize(host)

    ref_sess = ing.TailIngest(["a", "b", "c"], pair, geo,
                              adaptive=False, **kw)
    ref = ref_sess.finalize(host)
    assert ref_sess.link_diag["chunk_segs"] == 48
    np.testing.assert_allclose(
        np.asarray(out[0]), np.asarray(ref[0]), atol=0.05)
    want = np.array([delays[j] - delays[i] for i, j in pair], np.float64)
    np.testing.assert_allclose(np.asarray(out[0], np.float64), want,
                               atol=0.5)


def test_ingest_matches_batch_path(omaha_stations, station_csv, tmp_path):
    """Streamed chunked ingest vs the batch processor on the same
    capture bytes: corrected TDOAs within 0.05 samples, fix within a
    few meters (per-chunk vs per-block DC removal and the interleaved
    streaming split-σ are the only differences)."""
    scene = _scene(
        omaha_stations,
        clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]),
        seed=11,
    )
    paths, truth = write_scene_captures(scene, str(tmp_path))
    dat = [paths[n] for n in scene.station_names]
    kw = dict(seg_len=1 << 14, max_lag=512)
    proc = TDOAProcessor.from_csv(
        scene.ref_freq, scene.tgt_freq, station_csv, **kw
    )
    batch = proc.process_files(dat)
    stream = proc.process_files_overlapped(dat)
    np.testing.assert_allclose(
        stream.corrected_tdoa_samples,
        batch.corrected_tdoa_samples,
        atol=0.05,
    )
    np.testing.assert_allclose(
        stream.corrected_tdoa_samples, truth.tgt_tdoa_samples, atol=0.5
    )
    assert _fix_error_m(stream.fix, scene.tgt_tx_lla) < 150.0
    # The σ ladder must be live (split slots populated by the chunks).
    assert stream.tdoa_std_s is not None
    assert np.all(np.asarray(stream.tdoa_std_s) > 0)


def test_ingest_unsupported_options_raise(omaha_stations, station_csv,
                                          tmp_path):
    scene = _scene(omaha_stations, seed=5)
    paths, _ = write_scene_captures(scene, str(tmp_path))
    dat = [paths[n] for n in scene.station_names]
    proc = TDOAProcessor.from_csv(
        scene.ref_freq, scene.tgt_freq, station_csv,
        seg_len=1 << 14, max_lag=512, solve_velocity=True,
    )
    with pytest.raises(ValueError, match="overlapped ingest"):
        proc.process_files_overlapped(dat)


def test_tail_ingest_matches_batch(omaha_stations, station_csv, tmp_path):
    """TailIngest (the stream service's growing-file path) vs the batch
    processor on the same bytes: the session streams chunks as the
    'writer' appends, finalizes at close, and must reproduce the batch
    TDOAs — with nearly all chunks dispatched BEFORE the last byte (the
    freshness property: only the final chunk + finalize + solve remain
    at window close, instead of the whole transfer+compute)."""
    import time

    from tdoa_tpu.io.datfile import iq_bytes_as_u16
    from tdoa_tpu.pipeline.processor import HostCapture

    scene = _scene(
        omaha_stations,
        clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]),
        seed=11,
    )
    paths, truth = write_scene_captures(scene, str(tmp_path))
    dat = [paths[n] for n in scene.station_names]
    kw = dict(seg_len=1 << 14, max_lag=512)
    proc = TDOAProcessor.from_csv(
        scene.ref_freq, scene.tgt_freq, station_csv, **kw
    )
    batch = proc.process_files(dat)

    snames = sorted(scene.station_names)
    full = {}
    for n in snames:
        raw = np.memmap(paths[n], dtype=np.uint8, mode="r")
        full[n] = iq_bytes_as_u16(raw[: (raw.size // 2) * 2])
    bl = full[snames[0]].shape[0] // 3
    total = full[snames[0]].shape[0]
    caps = {n: HostCapture(u16=full[n], block_len=bl) for n in snames}

    def grow_window(sess, steps=10):
        """'Writer' appends in 10 steps; feeds the first ``steps`` of
        them and returns chunks dispatched before the final step."""
        before = 0
        for k in range(1, steps + 1):
            avail = total * k // 10
            d = sess.feed([full[n][:avail] for n in snames])
            if k < 10:
                before += d
        return before

    # 4 chunks per block (12 total) so growth actually interleaves.
    sess = proc.tail_session(snames, bl, chunk_samples=bl // 4)
    assert sess.total_chunks >= 9
    before_close = grow_window(sess)
    # Freshness structure: all but the last chunk(s) streamed while the
    # capture was still being written.
    assert before_close >= sess.total_chunks - 2
    res = proc.process_captures(caps, tail=sess)

    # Freshness wall-clock, on WARM jits (the service processes window
    # after window; first-compile costs on the CPU backend would
    # otherwise swamp the number): the work remaining after the last
    # byte — final chunk + finalize + solve — is bounded by the
    # round-4 target (<2 s to the fix), with ~10x margin at this scene
    # size. At THIS tiny scale the warm batch path is solve-dominated
    # too, so batch-vs-tail wall clock is a coin flip — the freshness
    # win is the structural before_close assertion above plus the
    # transfer overlap bench.py measures on hardware.
    sess2 = proc.tail_session(snames, bl, chunk_samples=bl // 4)
    grow_window(sess2, steps=9)  # capture still 1/10 short
    t0 = time.time()  # ...last byte lands now:
    proc.process_captures(caps, tail=sess2)  # drains + finalizes
    t_fresh = time.time() - t0
    assert t_fresh < 2.0

    # Pair bases differ only by station order; map via names.
    def tdoa_map(names, tdoas):
        from tdoa_tpu.solve.multilateration import station_pairs

        prs = station_pairs(len(names))
        return {
            frozenset((names[i], names[j])): (names[i], names[j], t)
            for (i, j), t in zip(np.asarray(prs), tdoas)
        }

    got = tdoa_map(snames, np.asarray(res.corrected_tdoa_samples))
    want = tdoa_map(batch.station_names,
                    np.asarray(batch.corrected_tdoa_samples))
    assert set(got) == set(want)
    for key in got:
        gi, gj, gt = got[key]
        wi, wj, wt = want[key]
        if (gi, gj) != (wi, wj):
            wt = -wt
        np.testing.assert_allclose(gt, wt, atol=0.05)
    assert _fix_error_m(res.fix, scene.tgt_tx_lla) < 150.0
    # σ ladder live (split slots populated by the streamed chunks).
    assert res.tdoa_std_s is not None
    assert np.all(np.asarray(res.tdoa_std_s) > 0)


def test_tail_ingest_size_mismatch_rejected(omaha_stations, station_csv,
                                            tmp_path):
    """A finished file whose block length disagrees with the session's
    assumption means every block-1/2 chunk mixed two blocks — the
    finalize must refuse (the service then falls back to the batch
    path) rather than emit a silently wrong fix."""
    from tdoa_tpu.io.datfile import iq_bytes_as_u16
    from tdoa_tpu.pipeline.processor import HostCapture

    scene = _scene(omaha_stations, seed=5)
    paths, _ = write_scene_captures(scene, str(tmp_path))
    snames = sorted(scene.station_names)
    full = {}
    for n in snames:
        raw = np.memmap(paths[n], dtype=np.uint8, mode="r")
        full[n] = iq_bytes_as_u16(raw[: (raw.size // 2) * 2])
    bl = full[snames[0]].shape[0] // 3
    proc = TDOAProcessor.from_csv(
        scene.ref_freq, scene.tgt_freq, station_csv,
        seg_len=1 << 14, max_lag=512,
    )
    # Session assumes a LONGER capture than the files actually are.
    sess = proc.tail_session(snames, bl + 4096)
    sess.feed([full[n] for n in snames])
    caps = {n: HostCapture(u16=full[n], block_len=bl) for n in snames}
    with pytest.raises(ValueError, match="mismatch"):
        proc.process_captures(caps, tail=sess)
    assert sess.mismatch is not None


def test_stream_processor_watch_tail_ingest(omaha_stations, station_csv,
                                            tmp_path, capsys):
    """End-to-end service test: collectors 'write' the window's .dat
    files incrementally while the --watch --overlap-ingest service
    polls; the service must stream chunks BEFORE the files close
    (tail-ingest progress on stderr) and emit the fix after."""
    import shutil
    import threading
    import time

    from tdoa_tpu.cli.stream_processor import main

    scene = _scene(omaha_stations, seed=23)
    stage_dir = tmp_path / "stage"
    stage_dir.mkdir()
    watch_dir = tmp_path / "watch"
    watch_dir.mkdir()
    paths, _ = write_scene_captures(scene, str(stage_dir))
    epoch = 1700000000
    duration_s = 3 * scene.block_len / scene.sample_rate

    def writer():
        """Append each station's bytes in 8 slices, round-robin (all
        stations grow together, like real collectors)."""
        srcs = {
            n: np.fromfile(paths[n], dtype=np.uint8)
            for n in scene.station_names
        }
        outs = {
            n: watch_dir / f"{n}-{epoch}.dat" for n in scene.station_names
        }
        nbytes = len(next(iter(srcs.values())))
        edges = [nbytes * k // 8 for k in range(9)]
        for a, b in zip(edges, edges[1:]):
            for n in scene.station_names:
                with open(outs[n], "ab") as fh:
                    fh.write(srcs[n][a:b].tobytes())
            time.sleep(0.2)

    t = threading.Thread(target=writer)
    t.start()
    try:
        rc = main([
            str(scene.ref_freq), str(scene.tgt_freq), station_csv,
            str(watch_dir),
            # settle 4x the writer's inter-slice gap so a mid-write
            # window never looks finished.
            "--watch", "0.1", "--settle", "0.8",
            "--overlap-ingest", str(duration_s),
            "--max-lag", "512", "--seg-len", str(1 << 14),
            # Tail-ingest progress counts as service activity, so the
            # idle clock only starts once the window is processed.
            "--idle-exit", "5",
        ])
    finally:
        t.join()
        shutil.rmtree(stage_dir, ignore_errors=True)
    out = capsys.readouterr()
    assert rc == 0
    assert "tail-ingest" in out.err  # chunks streamed during capture
    assert "fell back" not in out.err
    assert "fix" in out.out


def test_ingest_cli_flag(omaha_stations, station_csv, tmp_path, capsys):
    from tdoa_tpu.cli.processor import main

    scene = _scene(omaha_stations, seed=7)
    paths, _ = write_scene_captures(scene, str(tmp_path))
    rc = main([
        str(scene.ref_freq), str(scene.tgt_freq), station_csv,
        *[paths[n] for n in scene.station_names],
        "--overlap-ingest", "--max-lag", "512", "--seg-len", str(1 << 14),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Position fix:" in out


def test_tail_ingest_finalize_reports_missing_samples():
    """An incomplete capture raises a ValueError that names the samples
    the last chunk needs (the message used to read a removed field)."""
    from tdoa_tpu.pipeline import ingest as ing

    seg, block_len = 2048, 6 * 2048
    host = _delay_capture_u16(3, block_len, [0, 2, 4], seed=2)
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    sess = ing.TailIngest(["a", "b", "c"], pair, np.zeros(3, np.float32),
                          block_len=block_len, max_lag=256, seg_len=seg,
                          chunk_samples=2 * seg, adaptive=False)
    short = [v[: 2 * block_len] for v in host]
    b, s, l = sess._plan[-1]
    with pytest.raises(ValueError, match=f"needs {b * block_len + s + l} "
                                         "samples per station"):
        sess.finalize(short)


def test_chunk_lengths_cover_every_plan():
    """_chunk_lengths lists every chunk length a fresh plan or a re-plan
    after the first default chunk can dispatch, at every ladder size."""
    from tdoa_tpu.pipeline.ingest import (
        CHUNK_LADDER_SEGS,
        _chunk_lengths,
        plan_chunks,
    )

    seg = 1000
    block_len = 250 * seg + 77
    lengths = set(_chunk_lengths(block_len, seg))
    usable = (block_len // seg) * seg
    first = CHUNK_LADDER_SEGS[0] * seg
    for segs in CHUNK_LADDER_SEGS:
        _, spans = plan_chunks(block_len, seg, segs * seg)
        assert {n for _, n in spans} <= lengths
        _, rest = plan_chunks(usable - first, seg, segs * seg)
        assert {n for _, n in rest} <= lengths


def test_tail_ingest_warm_compiles_every_chunk_program(monkeypatch):
    """After warm(), streaming a whole capture — through a runtime
    chunk-size re-plan — compiles no further decode+accumulate
    program."""
    from tdoa_tpu.pipeline import ingest as ing

    clock = {"t": 0.0}
    real_put = ing._device_put

    def fake_put(x):
        clock["t"] += np.asarray(x).nbytes / 25e6
        return real_put(x)

    monkeypatch.setattr(ing, "_now", lambda: clock["t"])
    monkeypatch.setattr(ing, "_device_put", fake_put)
    monkeypatch.setattr(ing, "_measure_dispatch_rt", lambda: 0.1)

    seg = 1024
    block_len = 5 * 48 * seg + 3 * seg
    host = _delay_capture_u16(3, block_len, [0, 3, -2], seed=6)
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    sess = ing.TailIngest(["a", "b", "c"], pair, np.zeros(3, np.float32),
                          block_len=block_len, max_lag=128, seg_len=seg)
    assert sess.warm() > 0
    before = ing._decode_update._cache_size()
    sess.feed([v[: v.shape[0] // 2] for v in host])
    assert sess.link_diag["chunk_segs"] == 192  # re-planned mid-stream
    sess.finalize(host)
    assert ing._decode_update._cache_size() == before
