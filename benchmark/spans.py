"""The program's own spans in a traced run: the ``zk.*`` ranges that
zk_tpu_torch opens while a profiler records (``zk_tpu_torch.utils.stat``),
kept by ``trace.stop`` among the job thread's host ranges, in the
profiler's clock."""

from __future__ import annotations

import bisect


def in_steps(trace, step: str, name: str) -> list[tuple[int, int]] | None:
    """[(start, end)] in ns of the ranges named ``name`` that start inside
    the ``step`` steps; None where the trace holds no program span at all
    (a program that opens none)."""
    if trace is None or not any(n.startswith("zk.") for _, _, n in trace.host):
        return None
    steps = trace.steps.get(step, [])
    starts = [s for s, _ in steps]
    out = []
    for s, e, n in trace.host:
        if n == name:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < steps[i][1]:
                out.append((s, e))
    return out


def per_job(trace, step: str, name: str, scale: float) -> float | None:
    """Time inside ``name`` ranges in ``step`` steps, per step, over
    ``scale`` ns."""
    spans = in_steps(trace, step, name)
    if spans is None or not trace.steps.get(step):
        return None
    return sum(e - s for s, e in spans) / len(trace.steps[step]) / scale
