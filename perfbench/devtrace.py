"""Reading a ``torch.profiler`` trace of the benchmark's traced window.

The profiler's Chrome trace (``export_chrome_trace``) lists complete
("X") events with a category: device work is ``kernel``, ``gpu_memcpy``
and ``gpu_memset``; host work is ``cpu_op`` (an aten operator) and
``cuda_runtime`` / ``cuda_driver`` (a runtime call, such as a
synchronisation).  Times are microseconds on one clock.

``summarize`` gives the seconds in which some device operation ran (the
union of their intervals), the device operations that took most time by
name, and the idle gaps between device operations by what the host was
doing then: the innermost host event that covers the gap's middle,
summed over the gaps of each.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

#: entries kept in each list of the breakdown
TOP = 10


def load(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_labels(host, times):
    """For each time in ``times`` (sorted), the innermost host event that
    covers it, by one sweep over ``host`` (sorted by start; host events of
    a thread nest)."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host idle or untraced")
    return out


def summarize(events: list) -> dict:
    """{"busy_s", "span_s", "device_ops": [[name, s]], "idle_gaps":
    [[host activity, s]]} of one traced window; "span_s" runs from the
    first to the last device operation."""
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"busy_s": 0.0, "span_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    merged = _union((s, e) for s, e, _ in dev)
    busy_us = sum(e - s for s, e in merged)
    by_name: dict[str, float] = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events if e.get("cat") in HOST_CATS)
    holes = [(end, start) for (_, end), (start, _) in zip(merged, merged[1:])]
    gaps: dict[str, float] = {}
    for (end, start), label in zip(
            holes, _host_labels(host, [(e + s) / 2 for e, s in holes])):
        gaps[label] = gaps.get(label, 0.0) + (start - end)

    def top(d):
        return [[name, us / 1e6] for name, us in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": busy_us / 1e6,
            "span_s": (merged[-1][1] - merged[0][0]) / 1e6,
            "device_ops": top(by_name), "idle_gaps": top(gaps)}
