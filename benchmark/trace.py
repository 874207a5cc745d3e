"""The traced run's profile, reduced in memory: the device's operations and
busy time, the harness's step ranges, and where the device sat idle.

``torch.profiler`` records the window; nothing is written to disk.  The
harness's steps are ``record_function`` ranges named bench.<step> on the
host thread that runs the jobs, so every span here is in the profiler's
own clock.  A device operation is a kernel, a copy or a fill.
"""

from __future__ import annotations

import bisect
import subprocess
from collections import defaultdict
from dataclasses import dataclass



def _is_device_op(e) -> bool:
    """A kernel, copy or fill on the device: a device event that is not a
    ``record_function`` range mirrored onto the device's timeline."""
    if e.name().startswith("bench."):
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation is not None and annotation())


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.__enter__()
    if cuda:  # the profiler's first device operation can go missing: spend it here
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return prof


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(merged: list[tuple[int, int]], spans: list[tuple[int, int]]) -> int:
    """Length of the union ``merged`` (sorted, disjoint) inside the spans."""
    total = 0
    starts = [s for s, _ in merged]
    for s, e in spans:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(merged) and merged[i][0] < e:
            total += max(0, min(e, merged[i][1]) - max(s, merged[i][0]))
            i += 1
    return total


@dataclass
class Trace:
    window_ns: tuple[int, int]
    ops: list[tuple[int, int, str]]  # device operations in the window, by start
    busy: list[tuple[int, int]]  # their union
    steps: dict  # step name -> [(start, end)] in ns
    host: list[tuple[int, int, str]]  # the job thread's host ranges, by start

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return _overlap(self.busy, [self.window_ns]) / 1e9

    def ops_in(self, step: str) -> int:
        starts = [s for s, _, _ in self.ops]
        return sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s) for s, e in self.steps.get(step, []))

    def busy_in(self, step: str) -> float:
        return _overlap(self.busy, self.steps.get(step, [])) / 1e9

    def span_s(self, step: str) -> float:
        return sum(e - s for s, e in self.steps.get(step, [])) / 1e9

    def idle_gaps(self) -> list[tuple[int, int]]:
        w0, w1 = self.window_ns
        gaps, t = [], w0
        for s, e in self.busy:
            if s > t:
                gaps.append((t, min(s, w1)))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        return [(s, e) for s, e in gaps if e > s]

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle time by
        what the job thread was doing (its step and innermost host range)."""
        by_op = defaultdict(int)
        for s, e, name in self.ops:
            by_op[name[:120]] += e - s
        by_host = defaultdict(int)
        gaps = self.idle_gaps()
        stack: list[tuple[int, int, str]] = []
        i = 0
        for s, e in gaps:
            t = (s + e) // 2
            while i < len(self.host) and self.host[i][0] <= t:
                while stack and stack[-1][1] <= self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            step = next((n[6:] for _, _, n in reversed(stack) if n.startswith("bench.")), "between jobs")
            inner = next((n for _, _, n in reversed(stack) if not n.startswith("bench.")), "host code")
            by_host[f"{step}: {inner[:100]}"] += e - s
        top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def stop(prof) -> Trace:
    """End the profile and reduce it to the window spanned by the jobs."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    steps = defaultdict(list)
    job_thread = None
    for e in events:
        name = e.name()
        if name.startswith("bench.") and e.device_type() == torch.autograd.DeviceType.CPU:
            steps[name[6:]].append((e.start_ns(), e.start_ns() + e.duration_ns()))
            job_thread = e.start_thread_id()
    for v in steps.values():
        v.sort()
    starts = [s for spans in steps.values() for s, _ in spans]
    ends = [e for spans in steps.values() for _, e in spans]
    w = (min(starts), max(ends)) if starts else (0, 0)
    ops, host = [], []
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _is_device_op(e) and w[0] <= s < w[1]:
                ops.append((s, end, e.name()))
        elif e.start_thread_id() == job_thread and w[0] <= s < w[1]:
            host.append((s, end, e.name()))
    ops.sort()
    host.sort(key=lambda h: (h[0], -h[1]))
    return Trace(w, ops, _merge([(s, e) for s, e, _ in ops]), dict(steps), host)


def device_info(device: str, peak: int | None, count: int) -> dict:
    """The contract's device record (``count`` cards used, ``peak`` the
    fullest one's), with the first card's power limit beside it."""
    import torch

    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    info = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": count,
        "memory_peak_bytes": peak,
    }
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info
