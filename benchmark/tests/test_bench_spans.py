"""The readers of the program's own spans (benchmark/spans.py): numbers on a
traced CPU run of each cell cut small, nothing where the program opens no
span, as a program older than its spans does.  A cell's kind says which
readers read an exact number on the CPU and which read only on a card
(benchmark/tests/kinds/<kind>.py)."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark import trace as T
from benchmark.tests.conftest import cells, kind_tests, small_cell

READERS = ("prove_syncs", "round_enqueue_us", "prove_sync_wait_ms", "verifier_host_ms", "prove_decode_ms",
           "gkr_witness_ms", "gkr_chain_enqueue_ms", "gkr_final_sync_ms")


@pytest.mark.parametrize("name", cells())
def test_span_readers_read_a_traced_run(name):
    cell = small_cell(name)
    kind = kind_tests(cell.config["job"])
    readers = [m["name"] for m in cell.per_layer if m["name"] in READERS]  # the readers this cell reports
    assert readers
    line, _ = harness.run(cell, 2**33 + 17, 0.2, True, "cpu", time.perf_counter())
    on_cpu = [m for m in readers if m not in kind.SPANS_CARD_ONLY]
    got = {m: line["metrics"][m]["value"] for m in on_cpu}
    assert all(line["metrics"][m]["value"] == v for m, v in kind.SPANS_EXACT.items())
    assert all(v > 0 for v in got.values()), got
    assert not set(readers) & set(kind.SPANS_CARD_ONLY) & set(line["metrics"])


def test_span_readers_are_silent_without_program_spans():
    trace = T.Trace((0, 100), [], [], {"prove": [(0, 50)], "verify": [(50, 100)]}, [(10, 20, "aten::add")])
    run = harness.Run(small_cell(cells()[0]), 0.0, (0.0, 1.0), [], None, trace)
    assert [harness.load_module("metrics", m).read(run) for m in READERS] == [None] * len(READERS)
