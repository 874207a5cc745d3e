"""Shared fixtures of the benchmark's tests: cells cut to sizes a CPU run
holds, and the card check for the tests that need one.

What the shared tests need of a job kind sits in a file of its own,
benchmark/tests/kinds/<kind>.py, found by the kind's name as the harness
finds benchmark/jobs/<kind>.py: ``SMALL``, the configuration's sizes on
the CPU; ``faults(job)``, the faults that break its timed path; and
``SPANS_EXACT`` / ``SPANS_CARD_ONLY``, what its span readers read on a
traced CPU run."""

from __future__ import annotations

import pytest

from benchmark import harness


def kind_tests(job: str, root=harness.ROOT):
    """benchmark/tests/kinds/<job>.py of the checkout at root."""
    return harness.load_module("tests/kinds", job, root)


def small_cell(name: str, root=harness.ROOT) -> harness.Cell:
    """The cell with its kind's sizes for a test run on the CPU."""
    cell = harness.load_cell(name, root)
    cell.config.update(kind_tests(cell.config["job"], root).SMALL)
    return cell


def cells() -> list[str]:
    import json

    with open(harness.ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def card():
    """Skips where there is no CUDA card (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(autouse=True, scope="session")
def one_thread():
    """Small tensors: one thread a test process, so parallel workers do not
    oversubscribe the cores."""
    import torch

    torch.set_num_threads(1)
