"""Device time of the NCCL kernels (operations whose name holds ``nccl``)
that start inside the traced prove steps, per job, in ms: the collectives
of the sharded prove on rank 0's card, the wait for the other ranks
included.  Rank 0's trace stands for every rank: the ranks run the same
work in lockstep.  Nothing where no NCCL kernel ran (a run off the cards)."""

import bisect


def read(run):
    t = run.trace
    if t is None or not t.steps.get("prove"):
        return None
    steps = t.steps["prove"]
    starts = [s for s, _ in steps]
    total, seen = 0, False
    for s, e, name in t.ops:
        if "nccl" in name.lower():
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < steps[i][1]:
                total += e - s
                seen = True
    return total / len(steps) / 1e6 if seen else None
