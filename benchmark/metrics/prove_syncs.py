"""Device -> host reads (the program's ``zk.sync`` spans) that start inside a
prove step, per traced job."""

from benchmark import spans as S


def read(run):
    t = run.trace
    syncs = S.in_steps(t, "prove", "zk.sync")
    if syncs is None or not t.steps.get("prove"):
        return None
    return len(syncs) / len(t.steps["prove"])
