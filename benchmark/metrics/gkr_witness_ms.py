"""Host time in the program's ``zk.gkr.witness`` spans inside prove steps,
per traced job: the circuit evaluated on the card (every level's wire
values) and the output bytes read back, which waits for it.  Nothing
where the prove opens no such span."""

from benchmark import spans as S


def read(run):
    spans = S.in_steps(run.trace, "prove", "zk.gkr.witness")
    return S.per_job(run.trace, "prove", "zk.gkr.witness", 1e6) if spans else None
