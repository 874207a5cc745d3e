"""The readers of the program's own spans (benchmark/spans.py): numbers on a
traced CPU run of each cell cut small, nothing where the program opens no
span, as a program older than its spans does."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark import trace as T
from benchmark.tests.conftest import cells, small_cell

READERS = ("prove_syncs", "round_enqueue_us", "prove_sync_wait_ms", "verifier_host_ms")


@pytest.mark.parametrize("name", cells())
def test_span_readers_read_a_traced_run(name):
    line, _ = harness.run(small_cell(name), 2**33 + 17, 0.2, True, "cpu", time.perf_counter())
    got = {m: line["metrics"][m]["value"] for m in READERS}
    # on the CPU the default tier is the synced one: one round above the
    # 2^11 host tail reads its sums back, then the table is read
    assert got["prove_syncs"] == 2.0
    assert all(v > 0 for v in got.values()), got


def test_span_readers_are_silent_without_program_spans():
    trace = T.Trace((0, 100), [], [], {"prove": [(0, 50)], "verify": [(50, 100)]}, [(10, 20, "aten::add")])
    run = harness.Run(small_cell(cells()[0]), 0.0, (0.0, 1.0), [], None, trace)
    assert [harness.load_module("metrics", m).read(run) for m in READERS] == [None] * len(READERS)
