"""Shared fixtures of the benchmark's tests: cells cut to sizes a CPU run
holds, and the card check for the tests that need one."""

from __future__ import annotations

import pytest

from benchmark import harness

# the same cells at sizes a test run on the CPU holds, above the table size
# (2^11) at or below which the CPU tier finishes a sumcheck on host ints
SMALL = {"sumcheck": {"n_vars": 12}}


def small_cell(name: str, root=harness.ROOT) -> harness.Cell:
    cell = harness.load_cell(name, root)
    cell.config.update(SMALL[cell.config["job"]])
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
