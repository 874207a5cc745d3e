"""Device operations (kernels, copies, fills) that start inside a prove
step, per traced job."""


def read(run):
    t = run.trace
    if t is None or not t.ops:  # nothing ran on a device
        return None
    return t.ops_in("prove") / len(t.steps["prove"])
