"""Host time inside the program's device -> host reads (``zk.sync`` spans)
in prove steps, per traced job: the host waiting out the card's queue."""

from benchmark import spans as S


def read(run):
    return S.per_job(run.trace, "prove", "zk.sync", 1e6)
