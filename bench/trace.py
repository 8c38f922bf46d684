"""The device trace of a traced run: ``torch.profiler`` over a stretch of
flushes, reduced from its Chrome trace to the numbers the per-layer
readers take.

A stretch's window runs from the start of its first ``bench.flush``
annotation to the end of its last. Device work is every kernel, copy and
fill event; ``busy_s`` is the length of their union inside the window (a
plain sum would count overlapping events twice). Kernel launches are the
runtime's launch calls, so a kernel event the profiler dropped still
counts as a launch; ``kept`` is the share of launches whose kernel event
is in the trace.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

__all__ = ["FLUSH", "Profile", "summarize", "union", "kernel_seconds",
           "LAUNCH_CALLS"]

FLUSH = "bench.flush"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")
NAME_CHARS = 120


class Profile:
    """``torch.profiler`` started and stopped around one stretch; the
    events are read after the window from a Chrome trace written under
    ``TMPDIR`` and deleted at once."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self._prof = profile(activities=acts)
        self._prof.start()

    def stop(self):
        self._prof.stop()

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def union(intervals, lo: float, hi: float) -> list:
    """Merged [start, end) intervals, clipped to [lo, hi]."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _host_at(host, starts, t, reach: int = 512) -> str:
    """The innermost host event spanning ``t``: the latest-starting one
    among those that do, looked for among the ``reach`` events that
    started last before it."""
    i = bisect.bisect_right(starts, t)
    for h in reversed(host[max(0, i - reach):i]):
        if h[1] >= t:
            return h[2]
    return "python"


def summarize(events: list, top: int = 10) -> dict:
    """The numbers of one stretch, times in seconds: flushes, window,
    busy, kernel launches and the share kept, device time and count by
    kernel name, the device ops that took most time and the idle gaps by
    the host op under way (the innermost op or runtime call that spans
    the gap's middle; Python between ops where none does)."""
    ann = [e for e in _x(events, ("user_annotation",))
           if e.get("name") == FLUSH]
    if not ann:
        return {}
    lo = min(e["ts"] for e in ann)
    hi = max(e["ts"] + e["dur"] for e in ann)
    dev = [e for e in _x(events, DEVICE_CATS)
           if lo <= e["ts"] + e["dur"] and e["ts"] <= hi]
    merged = union([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo, hi)
    busy = sum(b - a for a, b in merged)
    launches = [e for e in _x(events, ("cuda_runtime", "cuda_driver"))
                if e.get("name") in LAUNCH_CALLS and lo <= e["ts"] <= hi]
    corr = {e.get("args", {}).get("correlation") for e in dev
            if e["cat"] == "kernel"}
    kept = sum(1 for e in launches
               if e.get("args", {}).get("correlation") in corr)
    kernels = defaultdict(lambda: [0, 0.0])
    by_name = defaultdict(float)
    for e in dev:
        name = e.get("name", "?")[:NAME_CHARS]
        by_name[name] += e["dur"] * 1e-6
        if e["cat"] == "kernel":
            kernels[name][0] += 1
            kernels[name][1] += e["dur"] * 1e-6
    host = sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", "?"))
                   for e in _x(events, HOST_CATS)), key=lambda h: h[0])
    starts = [h[0] for h in host]
    gaps = defaultdict(float)
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            name = _host_at(host, starts, (a + b) / 2)
            gaps[name[:NAME_CHARS]] += (b - a) * 1e-6
    rank = (lambda d: [[k, v] for k, v in
                       sorted(d.items(), key=lambda kv: -kv[1])[:top]])
    return {"flushes": len(ann), "window_s": (hi - lo) * 1e-6,
            "busy_s": busy * 1e-6, "launches": len(launches),
            "launches_kept": kept,
            "kernels": {k: {"count": c, "seconds": s}
                        for k, (c, s) in kernels.items()},
            "device_ops": rank(by_name), "idle_gaps": rank(gaps)}


def kernel_seconds(summary: dict, launches: dict, names, counter: str):
    """Device seconds of the kernels whose name holds one of ``names``
    (a template kernel's reads ``void name<...>(...)``) in a stretch's
    ``summary``: the kept events' sum, scaled to the launches the
    program's counter ``counter`` made in the stretch where the profiler
    dropped events. None where no event was kept."""
    kept = [v for k, v in (summary or {}).get("kernels", {}).items()
            if any(n in k for n in names)]
    count = sum(v["count"] for v in kept)
    if not count:
        return None
    seconds = sum(v["seconds"] for v in kept)
    return seconds * max(1.0, launches.get(counter, 0) / count)
