"""Mean host time of one sumcheck round (the program's ``zk.prove.round``
spans inside prove steps): the Python that queues the round's kernels."""

from benchmark import spans as S


def read(run):
    rounds = S.in_steps(run.trace, "prove", "zk.prove.round")
    if not rounds:
        return None
    return sum(e - s for s, e in rounds) / len(rounds) / 1e3
