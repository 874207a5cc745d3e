"""The GKR prove's least time on the card at its peaks (the larger of its
bytes read once over 3.35 TB/s and its needed field products'
multiply-adds over 16.73 T/s, from the matrix-multiplication circuit's
shape alone: benchmark/yardstick.py ``gkr_least_seconds``) over the
device's busy time inside the traced prove steps, in percent.  It counts
the protocol's work, not the kernels', so fusing or moving kernels
leaves the work as it is."""

from benchmark import yardstick as Y


def read(run):
    t, c = run.trace, run.cell.config
    if t is None or c["job"] != "gkr" or not t.busy_in("prove"):
        return None
    least = Y.gkr_least_seconds(Y.matmul_layers(c["n"]), c["n_limbs"])
    return 100.0 * least * len(t.steps["prove"]) / t.busy_in("prove")
