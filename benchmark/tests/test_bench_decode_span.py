"""The reader of the prove's decode span (``zk.prove.decode``): a number on
a traced CPU run of each cell cut small, nothing where the program opens no
span, as a program older than its spans does."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark import trace as T
from benchmark.tests.conftest import cells, small_cell


@pytest.mark.parametrize("name", cells())
def test_decode_reader_reads_a_traced_run(name):
    line, _ = harness.run(small_cell(name), 2**33 + 29, 0.2, True, "cpu", time.perf_counter())
    assert line["metrics"]["prove_decode_ms"]["value"] > 0


def test_decode_reader_is_silent_without_program_spans():
    trace = T.Trace((0, 100), [], [], {"prove": [(0, 50)], "verify": [(50, 100)]}, [(10, 20, "aten::add")])
    run = harness.Run(small_cell(cells()[0]), 0.0, (0.0, 1.0), [], None, trace)
    assert harness.load_module("metrics", "prove_decode_ms").read(run) is None
