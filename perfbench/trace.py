"""The reduction of a ``torch.profiler`` stretch to what the readers and
the result line take: each device operation's seconds and launches by
name, the seconds in which any operation ran on the device (busy), and
the idle gaps by what the host was doing halfway through them (the
innermost CPU event then running).

The profiler keeps its events in memory; nothing is written to disk.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

# a gap shorter than this is launch spacing, not idleness worth naming
MIN_GAP_US = 5.0
# the prefix of the harness's spans (``bench.Spans``)
ANNOTATION = "perfbench."
TOP = 10


def _device_events(events):
    """The operations that ran on the device: kernels, copies and sets,
    without the spans' annotations the profiler mirrors onto the device's
    timeline."""
    return [e for e in events if e.device_type != DeviceType.CPU
            and e.time_range.end > e.time_range.start
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(ANNOTATION)]


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(roots, t, children):
    """The name of the innermost CPU event running at ``t`` (us), or
    None; ``roots`` the top-level events sorted by start; ``children``
    caches each event's children so sorted, with their starts."""
    name = None
    level = roots
    while level[0]:
        i = bisect.bisect_right(level[1], t) - 1
        if i < 0 or level[0][i].time_range.end < t:
            break
        event = level[0][i]
        name = event.name
        level = children.get(id(event))
        if level is None:
            kids = sorted(event.cpu_children,
                          key=lambda e: e.time_range.start)
            level = children[id(event)] = (
                kids, [e.time_range.start for e in kids])
    return name


def summarize(prof, wall_s: float, steps: int) -> Dict:
    """``prof``: a stopped profiler over ``steps`` whole steps that took
    ``wall_s`` seconds between synchronizes. Returns ``kernels`` (name ->
    [seconds, launches]), ``busy_s``, ``window_s``, ``steps`` and
    ``breakdown`` (the ten device operations that took most time, the
    ten host activities under which the device idled longest)."""
    events = prof.events()
    device = _device_events(events)
    kernels: Dict[str, List[float]] = {}
    for e in device:
        k = kernels.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e6
        k[1] += 1
    merged = _merge([(e.time_range.start, e.time_range.end) for e in device])
    busy_us = sum(end - start for start, end in merged)

    top = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.cpu_parent is None), key=lambda e: e.time_range.start)
    roots = (top, [e.time_range.start for e in top])
    children: Dict[int, tuple] = {}
    idle: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        if nxt - end < MIN_GAP_US:
            continue
        name = _innermost(roots, (end + nxt) / 2, children) or "host"
        idle[name] = idle.get(name, 0.0) + (nxt - end) / 1e6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"kernels": kernels, "busy_s": busy_us / 1e6,
            "window_s": wall_s, "steps": steps,
            "breakdown": {"device_ops": [[n, v[0]] for n, v in top_ops],
                          "idle_gaps": [[n, v] for n, v in top_gaps]}}


def kernel_time(profile: Dict, *needles: str) -> Tuple[float, int]:
    """Seconds and launches of the device operations whose names hold any
    of ``needles``."""
    seconds, count = 0.0, 0
    for name, (s, n) in profile["kernels"].items():
        if any(x in name for x in needles):
            seconds += s
            count += n
    return seconds, count
