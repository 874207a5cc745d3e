"""What decides ``correct`` fails where it must: the control (the plain
reference with its challenges cut to 128 bits, in the program's place) and
runs whose timed path is broken underneath, by each kind's own faults
(benchmark/tests/kinds/<kind>.py).  On the CPU at sizes a test run holds;
benchmark/control.py reads the control at the cells' own sizes on the
card."""

from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import cells, kind_tests, small_cell


@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct(name):
    cell = small_cell(name)
    kind = harness.load_module("jobs", cell.config["job"])
    state = kind.setup(cell.config, cell.traffic, 2**33 + 1, "cpu")
    numbers = kind.control(state, list(range(cell.traffic["pool"])))
    assert any(v > limit for _, v, limit in numbers), numbers


@pytest.mark.parametrize("name", cells())
def test_faults_make_correct_false(name, monkeypatch):
    cell = small_cell(name)
    kind = harness.load_module("jobs", cell.config["job"])
    state = kind.setup(cell.config, cell.traffic, 2**35 + 7, "cpu")  # sound set-up, then break the timed path
    monkeypatch.setattr(kind, "setup", lambda *a: state)
    faults = list(kind_tests(cell.config["job"]).faults(kind))
    across = ["exchange left out"] if cell.config.get("ranks", 1) > 1 else []  # a kind on several cards
    assert [f for f, _ in faults] == ["state unchanged", "half the batch", "answer altered"] + across
    for fault, patches in faults:
        with monkeypatch.context() as m:
            for obj, attr, value in patches:
                m.setattr(obj, attr, value)
            line, checks = harness.run(cell, 2**35 + 7, 0.2, False, "cpu", time.perf_counter())
        assert line["correct"] is False, (fault, checks)
