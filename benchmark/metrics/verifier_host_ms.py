"""Host time of the sumcheck verifier's round checks (the program's
``zk.verify`` spans: host Keccak, interpolation, evaluation) in verify
steps, per traced job."""

from benchmark import spans as S


def read(run):
    return S.per_job(run.trace, "verify", "zk.verify", 1e6)
