"""What decides ``correct`` fails where it must: the control (the plain
reference with its challenges cut to 128 bits, in the program's place) and
runs whose timed path is broken underneath.  On the CPU at sizes a test
run holds; benchmark/control.py reads the control at the cells' own sizes
on the card."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import cells, small_cell


@pytest.mark.parametrize("name", cells())
def test_control_is_not_correct(name):
    cell = small_cell(name)
    kind = harness.load_module("jobs", cell.config["job"])
    state = kind.setup(cell.config, cell.traffic, 2**33 + 1, "cpu")
    numbers = kind.control(state, list(range(cell.traffic["pool"])))
    assert any(v > limit for _, v, limit in numbers), numbers


def _stale_fold(orig):
    """A fold that returns its state unchanged: the low half as it was."""
    def fold(field, stack, size, r, out):
        return orig(field, stack, size, torch.zeros_like(r), out=out)
    return fold


def _half_sums(orig):
    """Round sums over the first half of the pairs, doubled: half of the
    batch left out, the mean taken over the rest."""
    def term_sums(field, degree, ks, stack, size):
        h, q = size // 2, size // 4
        if q == 0:
            return orig(field, degree, ks, stack, size)
        part = torch.cat([stack[:, :, :q], stack[:, :, h : h + q]], dim=-1)
        return 2 * orig(field, degree, ks, part, h)
    return term_sums


def _altered_sumcheck(orig):
    """A round value altered where the prover produces it."""
    def prove_partial(poly, total, **kw):
        proof, challenges = orig(poly, total, **kw)
        proof.round_polys[1][0] = (proof.round_polys[1][0] + 1) % poly.field.p
        return proof, challenges
    return staticmethod(prove_partial)


def _faults():
    import zk_tpu_torch
    from zk_tpu_torch.sumcheck import capacity as C

    P = zk_tpu_torch.SumcheckProver
    yield "state unchanged", [(C, "fold", _stale_fold(C.fold)), (C, "fold_halfsums", _stale_fold(C.fold_halfsums))]
    yield "half the batch", [(C, "term_sums", _half_sums(C.term_sums))]
    yield "answer altered", [(P, "prove_partial", _altered_sumcheck(P.prove_partial))]


@pytest.mark.parametrize("name", cells())
def test_faults_make_correct_false(name, monkeypatch):
    cell = small_cell(name)
    kind = harness.load_module("jobs", cell.config["job"])
    state = kind.setup(cell.config, cell.traffic, 2**35 + 7, "cpu")  # sound set-up, then break the timed path
    monkeypatch.setattr(kind, "setup", lambda *a: state)
    for fault, patches in list(_faults()):
        with monkeypatch.context() as m:
            for obj, attr, value in patches:
                m.setattr(obj, attr, value)
            line, checks = harness.run(cell, 2**35 + 7, 0.2, False, "cpu", time.perf_counter())
        assert line["correct"] is False, (fault, checks)
