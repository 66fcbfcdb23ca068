"""The device's side of a traced run: ``torch.profiler`` over a few calls,
reduced to busy, kernel and copy seconds per card and to the breakdown.

The profiler's Chrome trace lists every operation the cards ran
(categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``) with its card, start
and duration, and the host ranges the benchmark opened
(``user_annotation``), on one clock.  A card's busy time is the union of
its operations' intervals inside the traced window: operations that
overlap, on several streams, count once.  Kernel and copy seconds are
sums, which is what a roofline divides by.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL = "bench.call"


@dataclass
class DeviceTrace:
    calls: int
    window_s: float                                   # first call's start to the last's end
    busy_s: dict = field(default_factory=dict)        # card -> union of its operations, s
    kernel_s: dict = field(default_factory=dict)      # card -> summed kernel time, s
    copy_s: dict = field(default_factory=dict)        # card -> summed memcpy time, s
    device_ops: list = field(default_factory=list)    # [name, s], the most time first
    idle_gaps: list = field(default_factory=list)     # [host activity, s], the most first


def profile_calls(call, n: int, cards: list, spans, sync) -> DeviceTrace:
    """Run ``call`` ``n`` times under the profiler, each inside a
    ``bench.call`` range, ``sync()`` after the last; reduce the trace for
    ``cards`` (device indices)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cards and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    spans.annotate = True
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=activities) as prof:
            for _ in range(n):
                with record_function(CALL):
                    call()
            sync()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        spans.annotate = False
        os.unlink(path)
    return reduce(events, n, cards)


def _union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list, n: int, cards: list) -> DeviceTrace:
    """A ``DeviceTrace`` from Chrome-trace events (times in microseconds)."""
    calls = [e for e in events if e.get("ph") == "X" and e.get("name") == CALL]
    lo = min(e["ts"] for e in calls)
    hi = max(e["ts"] + e["dur"] for e in calls)
    out = DeviceTrace(calls=n, window_s=(hi - lo) / 1e6)
    by_card: dict = {c: [] for c in cards}
    by_name: dict = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        card = int(e.get("args", {}).get("device", -1))
        if card not in by_card:
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        by_card[card].append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e6
        sink = {"kernel": out.kernel_s, "gpu_memcpy": out.copy_s}.get(e["cat"])
        if sink is not None:
            sink[card] = sink.get(card, 0.0) + (b - a) / 1e6
    merged = {c: _union(iv) for c, iv in by_card.items()}
    out.busy_s = {c: sum(b - a for a, b in m) / 1e6 for c, m in merged.items()}
    out.device_ops = [[k[:160], v] for k, v in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]
    out.idle_gaps = _idle_gaps(merged[cards[0]], lo, hi, events) if cards else []
    return out


def _idle_gaps(busy: list, lo: float, hi: float, events: list) -> list:
    """The first card's idle time inside the window, split by the
    innermost host range open over each part of it (``call, no span``
    where only the call is open, ``outside calls`` where none is)."""
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    sums: dict = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        cuts = sorted({a, b, *(x for r in ranges for x in r[:2] if a < x < b)})
        for c, d in zip(cuts, cuts[1:]):
            mid = (c + d) / 2
            open_ = [r for r in ranges if r[0] <= mid < r[1]]
            name = max(open_, key=lambda r: r[0])[2] if open_ else "outside calls"
            name = "call, no span" if name == CALL else name
            sums[name] = sums.get(name, 0.0) + (d - c) / 1e6
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])[:10]]
