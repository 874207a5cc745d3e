"""Host time in the program's ``zk.gkr.layer_chain`` spans inside prove
steps, per traced job: the host queueing every layer of the device chain
(eq tables, phase tables, both phases' round records, the line step),
which the card may not yet have run.  Nothing where the prove opens no
such span (a prover off the device chain, as on the CPU)."""

from benchmark import spans as S


def read(run):
    spans = S.in_steps(run.trace, "prove", "zk.gkr.layer_chain")
    return S.per_job(run.trace, "prove", "zk.gkr.layer_chain", 1e6) if spans else None
