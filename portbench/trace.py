# coding=utf-8
"""Reading a torch.profiler trace (Chrome trace JSON) of the traced
episodes: device busy time, idle gaps by what the host was doing, device
time by operation, and the records of one kernel.

Device activity is every event of category ``kernel``, ``gpu_memcpy`` or
``gpu_memset``; the window is the span of the harness's own annotations
(``portbench.*``) in the traced episodes.  CUPTI can drop kernel records, so
a reader that uses a kernel's records compares their count with the
launches the program counted.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
SPAN_PREFIX = "portbench."


class Trace(NamedTuple):
    device: List[Tuple[float, float, str]]  # (start s, end s, name)
    spans: List[Tuple[float, float, str]]  # harness annotations
    host: List[Tuple[float, float, str]]  # host ops and runtime calls
    start: float  # window start, s (trace clock)
    end: float  # window end, s


def load(path: str) -> Trace:
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    device, spans, host = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        t0 = float(ev["ts"]) * 1e-6
        t1 = t0 + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), str(ev.get("name", ""))
        if cat in DEVICE_CATS:
            device.append((t0, t1, name))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((t0, t1, name[len(SPAN_PREFIX):]))
        elif cat in HOST_CATS:
            host.append((t0, t1, name))
    if not spans:
        raise ValueError(f"{path}: no {SPAN_PREFIX}* annotations")
    device.sort()
    spans.sort()
    host.sort()
    return Trace(device, spans, host, spans[0][0], max(s[1] for s in spans))


def _merged(intervals: Sequence[Tuple[float, float, str]], lo: float,
            hi: float) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for t0, t1, _ in intervals:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def busy_seconds(tr: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    return sum(b - a for a, b in _merged(tr.device, tr.start, tr.end))


def window_seconds(tr: Trace) -> float:
    return tr.end - tr.start


def _covering(items, starts, t: float, back: int) -> Optional[str]:
    """The innermost (latest-starting) of the last ``back`` items starting
    at or before t that covers t."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(-1, i - 1 - back), -1):
        t0, t1, name = items[j]
        if t0 <= t <= t1 and (best is None or t0 > best[0]):
            best = (t0, name)
    return None if best is None else best[1]


def idle_by_host(tr: Trace, top: int = 10) -> List[List]:
    """Idle device seconds grouped by what the host was doing at each gap's
    midpoint: ``<harness span>/<innermost host op or runtime call>``
    (``python`` where no op ran), the largest ``top`` groups."""
    busy = _merged(tr.device, tr.start, tr.end)
    edges = [tr.start] + [x for iv in busy for x in iv] + [tr.end]
    span_starts = [s[0] for s in tr.spans]
    host_starts = [h[0] for h in tr.host]
    groups: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        span = _covering(tr.spans, span_starts, mid, 4) or "loop"
        op = _covering(tr.host, host_starts, mid, 32) or "python"
        key = f"{span}/{op}"
        groups[key] = groups.get(key, 0.0) + (b - a)
    ranked = sorted(groups.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in ranked]


def device_ops(tr: Trace, top: int = 10) -> List[List]:
    """Device seconds by operation name (the first 120 characters), the
    largest ``top``."""
    totals: Dict[str, float] = {}
    for t0, t1, name in tr.device:
        lo, hi = max(t0, tr.start), min(t1, tr.end)
        if hi > lo:
            totals[name[:120]] = totals.get(name[:120], 0.0) + (hi - lo)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    return [[k, v] for k, v in ranked]


def kernel_records(tr: Trace, names: Sequence[str]) -> List[float]:
    """Durations (s) of the window's records of the kernels named (whole
    identifiers inside the profiler's demangled names)."""
    pat = re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(map(re.escape, names))
                     + r")(?![A-Za-z0-9_])")
    return [t1 - t0 for t0, t1, name in tr.device
            if tr.start <= t0 < tr.end and pat.search(name)]
