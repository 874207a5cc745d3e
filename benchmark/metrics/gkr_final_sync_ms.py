"""Host time in the program's ``zk.gkr.final_sync`` spans inside prove
steps, per traced job: the host waiting out the card's queue at the
chain's one read, then decoding every round polynomial, line and claim.
Nothing where the prove opens no such span (a prover off the device
chain, as on the CPU)."""

from benchmark import spans as S


def read(run):
    spans = S.in_steps(run.trace, "prove", "zk.gkr.final_sync")
    return S.per_job(run.trace, "prove", "zk.gkr.final_sync", 1e6) if spans else None
