"""The 95th percentile (nearest rank) of the prove spans of every job of
the window."""

import math


def read(run):
    spans = sorted(e - s for s, e in run.spans("prove"))
    return spans[math.ceil(0.95 * len(spans)) - 1] if spans else None
