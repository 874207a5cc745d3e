"""Host time in the program's ``zk.prove.decode`` spans inside prove steps,
per traced job: the read-back round record turned into ints (and any host
tail), after the one read, while the card has nothing queued."""

from benchmark import spans as S


def read(run):
    return S.per_job(run.trace, "prove", "zk.prove.decode", 1e6)
