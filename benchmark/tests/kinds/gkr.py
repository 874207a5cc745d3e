"""The GKR kind in the benchmark's tests: its size on the CPU, the faults
that break its timed path underneath, and what its span readers read on
a traced CPU run.  On the CPU the program proves with its per-phase
prover, on the card with the device chain; both build their phase tables
through ``gkr.device.scatter_table``."""

from __future__ import annotations

SMALL = {"n": 8}
SPANS_EXACT = {}
# the device chain's spans: the CPU's per-phase prover opens neither
SPANS_CARD_ONLY = ("gkr_chain_enqueue_ms", "gkr_final_sync_ms")


def _zero_tables(orig):
    """Phase tables left at zero: the state never built."""
    def scatter_table(field, size, pos, vals):
        return orig(field, size, pos[:0], vals[:, :0])
    return scatter_table


def _half_gates(orig):
    """Phase tables built from the first half of the gates, doubled: half
    of the batch left out, the mean taken over the rest."""
    def scatter_table(field, size, pos, vals):
        from zk_tpu_torch.fields import device as dev

        h = max(1, pos.shape[0] // 2)
        t = orig(field, size, pos[:h], vals[:, :h])
        return dev.add_mod(field, t, t)
    return scatter_table


def _altered_round(orig):
    """A round value of the proof altered where the prover produces it."""
    def prove(field, circuit, inputs, **kw):
        proof, levels = orig(field, circuit, inputs, **kw)
        rp = proof.layer_proofs[0].sumcheck.round_polys
        rp[1][0] = (rp[1][0] + 1) % field.p
        return proof, levels
    return staticmethod(prove)


def faults(job):
    """(name, [(object, attribute, replacement)]) of each fault."""
    import zk_tpu_torch
    from zk_tpu_torch.gkr import device as gdev

    P = zk_tpu_torch.GKRProver
    yield "state unchanged", [(gdev, "scatter_table", _zero_tables(gdev.scatter_table))]
    yield "half the batch", [(gdev, "scatter_table", _half_gates(gdev.scatter_table))]
    yield "answer altered", [(P, "prove", _altered_round(P.prove))]
