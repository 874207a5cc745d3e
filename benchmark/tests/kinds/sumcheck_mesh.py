"""The sharded sumcheck kind in the benchmark's tests: its size on the CPU
(4 gloo ranks), the faults that break its timed path underneath, patched
in rank 0 (the test's process) alone, and what its span readers read on a
traced CPU run."""

from __future__ import annotations

from benchmark import harness

# 2^10 entries a rank: above the 2 R-entry table at which the CPU tier
# finishes a sharded sumcheck on host ints
SMALL = {"n_vars": 12}
# on the CPU the sharded prove is the synced tier: each of the 9 sharded
# rounds above a rank's 2-entry table reads its sums back, then the
# gathered 8-entry table is read
SPANS_EXACT = {"prove_syncs": 10.0}
SPANS_CARD_ONLY = ()


def _lone_all_reduce(orig):
    """Rank 0 joins every all_reduce and keeps its own partials: the
    exchange between the cards left out, without a collective missing."""
    def all_reduce(self, t):
        orig(self, t.clone())
        return t
    return all_reduce


def _altered_sumcheck(orig):
    """A round value altered where the prover produces it."""
    def prove_partial(mesh, poly, total, **kw):
        proof, challenges = orig(mesh, poly, total, **kw)
        proof.round_polys[1][0] = (proof.round_polys[1][0] + 1) % poly.field.p
        return proof, challenges
    return staticmethod(prove_partial)


def faults(job):
    """(name, [(object, attribute, replacement)]) of each fault."""
    from zk_tpu_torch.parallel import MeshGroup, ShardedSumcheckProver
    from zk_tpu_torch.sumcheck import capacity as C

    base = harness.load_module("tests/kinds", "sumcheck")
    P = ShardedSumcheckProver
    yield "state unchanged", [(C, "fold", base._stale_fold(C.fold)),
                              (C, "fold_halfsums", base._stale_fold(C.fold_halfsums))]
    yield "half the batch", [(C, "term_sums", base._half_sums(C.term_sums))]
    yield "answer altered", [(P, "prove_partial", _altered_sumcheck(P.prove_partial))]
    yield "exchange left out", [(MeshGroup, "all_reduce", _lone_all_reduce(MeshGroup.all_reduce))]
