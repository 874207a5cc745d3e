"""One rank's share of the sharded prove's least time on the card at its
peaks (benchmark/yardstick.py ``sumcheck_least_seconds`` of its
2^(n_vars - log2 ranks)-entry shards: their bytes read once over 3.35 TB/s,
or their needed field products' multiply-adds over 16.73 T/s) over rank
0's device busy time inside the traced prove steps, in percent.  Rank 0's
trace stands for every rank: the ranks run the same work in lockstep."""

from benchmark import yardstick as Y


def read(run):
    t, c = run.trace, run.cell.config
    if t is None or c["job"] != "sumcheck_mesh" or not t.busy_in("prove"):
        return None
    tr = run.cell.traffic
    least = Y.sumcheck_least_seconds(c["n_vars"] - (c["ranks"].bit_length() - 1), tr["degree"], tr["factors"],
                                     c["n_limbs"])
    return 100.0 * least * len(t.steps["prove"]) / t.busy_in("prove")
