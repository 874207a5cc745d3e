"""The sumcheck kind in the benchmark's tests: its size on the CPU, the
faults that break its timed path underneath, and what its span readers
read on a traced CPU run."""

from __future__ import annotations

import torch

# above the table size (2^11) at or below which the CPU tier finishes a
# sumcheck on host ints
SMALL = {"n_vars": 12}
# on the CPU the default tier is the synced one: one round above the 2^11
# host tail reads its sums back, then the table is read
SPANS_EXACT = {"prove_syncs": 2.0}
SPANS_CARD_ONLY = ()


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


def faults(job):
    """(name, [(object, attribute, replacement)]) of each fault."""
    import zk_tpu_torch
    from zk_tpu_torch.sumcheck import capacity as C

    P = zk_tpu_torch.SumcheckProver
    yield "state unchanged", [(C, "fold", _stale_fold(C.fold)), (C, "fold_halfsums", _stale_fold(C.fold_halfsums))]
    yield "half the batch", [(C, "term_sums", _half_sums(C.term_sums))]
    yield "answer altered", [(P, "prove_partial", _altered_sumcheck(P.prove_partial))]
