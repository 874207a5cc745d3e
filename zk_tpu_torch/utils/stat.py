"""Nested wall-clock scope timers and analytic field-op counters (the
port's copy of ``zk_tpu.utils.stat``).

The timers are the reference stat crate's start_timer!/end_timer!
(stat/src/lib.rs:13-56): a thread-local stack of (label, start), indented
begin/end lines on stderr, printed only when the environment variable
PERF_LOG is "true".  A timer reads the host clock: around work queued on
the card it measures the enqueue, unless the scope ends in a host read.
The op counts are deterministic functions of (n, degree, k).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

_STATE = threading.local()


def _enabled() -> bool:
    return os.environ.get("PERF_LOG") == "true"


def _stack() -> list:
    if not hasattr(_STATE, "blocks"):
        _STATE.blocks = []
    return _STATE.blocks


def start_timer(label: str) -> None:
    """stat/src/lib.rs:13-30."""
    if not _enabled():
        return
    blocks = _stack()
    indent = " " * len(blocks)
    blocks.append((label, time.perf_counter()))
    print(f"\n{indent}{label} (begin)", file=sys.stderr, flush=True)


def end_timer() -> None:
    """stat/src/lib.rs:34-56."""
    if not _enabled():
        return
    blocks = _stack()
    label, start = blocks.pop()
    elapsed = time.perf_counter() - start
    print(f"{' ' * len(blocks)}{label} (end): {elapsed * 1e3:.3f}ms\n", file=sys.stderr, flush=True)


@contextmanager
def timer(label: str):
    start_timer(label)
    try:
        yield
    finally:
        end_timer()


# ------------------------------------------------------------- op counting


def mle_eval_mults(n_vars: int) -> int:
    """Field mults for a full n-var MLE evaluation: one per index pair
    (evaluation_form.rs:68) summed over the shrinking fold."""
    return (1 << n_vars) - 1


def sumcheck_prover_mults(n_vars: int, degree: int, k: int) -> int:
    """Field mults for the sumcheck prover round loop (prover.rs:44-68):
    per round on a size-s table, (degree-1) speculative lerp folds (the
    0/1 points are multiplication-free) + k-1 prod_reduce mults per
    element + the real fold, summed over halving rounds."""
    total = 0
    s = 1 << n_vars
    while s > 1:
        half = s // 2
        total += (degree - 1) * k * half + (k - 1) * half * (degree + 1) + k * half
        s = half
    return total
