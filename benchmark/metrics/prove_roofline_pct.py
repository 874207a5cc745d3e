"""The sumcheck prove's least time on the card at its peaks (the larger of
its statement's bytes read once over 3.35 TB/s and its needed field
products' multiply-adds over 16.73 T/s, benchmark/yardstick.py) over the
device's busy time inside the traced prove steps, in percent.  It counts
the protocol's work, not the kernels', so fusing or renaming kernels
leaves the work as it is."""

from benchmark import yardstick as Y


def read(run):
    t = run.trace
    if t is None or run.cell.config["job"] != "sumcheck" or not t.busy_in("prove"):
        return None
    c, tr = run.cell.config, run.cell.traffic
    least = Y.sumcheck_least_seconds(c["n_vars"], tr["degree"], tr["factors"], c["n_limbs"])
    return 100.0 * least * len(t.steps["prove"]) / t.busy_in("prove")
