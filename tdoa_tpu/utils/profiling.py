"""Tracing and per-stage timing — the observability the reference lacks
(SURVEY.md §5: "Tracing/profiling: none; printf-based progress").

Three layers:
- ``trace(dir)``: a context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable device trace of everything inside it;
- ``device_stage_times``: the reduction of such a trace to device busy
  time per named stage (``jax.named_scope`` in the pipeline:
  ``segment_fft_accumulate``, ``split_sigma_probe``,
  ``fm_demod_decimate``);
- ``StageTimer``: wall-clock stage accounting with explicit device sync,
  so stage times mean what they say under async dispatch.
"""

from __future__ import annotations

import contextlib
import re
import time
from typing import Dict, List, Optional, Tuple

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace into ``log_dir``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync(x) -> None:
    """Wait for every array in the pytree ``x`` to be computed."""
    jax.block_until_ready(x)


# The pipeline's named device stages (jax.named_scope names).
STAGE_SCOPES = ("segment_fft_accumulate", "split_sigma_probe",
                "fm_demod_decimate")


def _newest_xplane(trace_dir: str) -> str:
    import glob
    import os

    found = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not found:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(found, key=os.path.getmtime)


# A path element, possibly wrapped by transforms: ``jvp(name)``.
_SCOPE_ELEM = re.compile(r"^(?:[\w.]+\()*([\w.]+)\)*$")


def _scope_of(texts, scopes) -> Optional[str]:
    """The innermost of ``scopes`` that is a whole element of a
    ``named_scope`` path (``jit(f)/outer/inner/op``) in ``texts``, or
    None. Transform wrappers such as ``jvp(inner)`` count as ``inner``;
    a scope name that is only a substring of an element never matches."""
    for text in texts:
        for elem in reversed(str(text).split("/")):
            m = _SCOPE_ELEM.match(elem.strip())
            if m and m.group(1) in scopes:
                return m.group(1)
    return None


def device_stage_times(profile, scopes=STAGE_SCOPES) -> Dict:
    """Device time per stage from a ``jax.profiler`` trace.

    ``profile`` is a trace directory or a ``jax.profiler.ProfileData``.
    Each GPU plane's stream events (kernels and copies) are summed; an
    event counts toward the innermost scope that is an element of the
    ``named_scope`` path in its name or stats (XLA carries the op's path
    there, except inside command buffers), so each event counts toward
    at most one scope and the scopes never sum past ``device_ns``.
    Returns nanoseconds: ``device_ns`` (sum of event durations),
    ``busy_ns`` (union of their intervals), ``window_ns`` (first start
    to last end), ``events``, ``scopes`` {scope: ns} and ``longest``
    (the five longest events as (name, ns, name-and-stats text))."""
    if isinstance(profile, str):
        profile = jax.profiler.ProfileData.from_file(_newest_xplane(profile))
    scopes = tuple(scopes)
    per = {sc: 0.0 for sc in scopes}
    total = 0.0
    spans = []
    longest = []
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                dur = float(ev.duration_ns)
                total += dur
                spans.append((float(ev.start_ns), float(ev.start_ns) + dur))
                texts = [ev.name] + [str(v) for _, v in ev.stats]
                longest.append((dur, ev.name, " ".join(texts)[:300]))
                sc = _scope_of(texts, scopes)
                if sc is not None:
                    per[sc] += dur
    assert sum(per.values()) <= total * (1 + 1e-12), (per, total)
    busy = 0.0
    end = None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0.0)
    longest.sort(reverse=True)
    return {"device_ns": total, "busy_ns": busy, "window_ns": window,
            "events": len(spans), "scopes": per,
            "longest": [(n, d, t) for d, n, t in longest[:5]]}


class StageTimer:
    """Accumulates (stage → seconds) with device-synchronized edges.

    Usage::

        timer = StageTimer()
        with timer.stage("correlate"):
            out = correlate(...)
            timer.observe(out)   # sync point inside the stage
    """

    def __init__(self):
        self.times: Dict[str, float] = {}
        self.order: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.times:
                self.order.append(name)
                self.times[name] = 0.0
            self.times[name] += dt

    def observe(self, x) -> None:
        sync(x)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"total {total*1e3:8.1f} ms"]
        for name in self.order:
            t = self.times[name]
            lines.append(
                f"  {name:<20s} {t*1e3:8.1f} ms  ({100*t/max(total,1e-12):4.1f}%)"
            )
        return "\n".join(lines)
