"""The share of the traced prove steps' time in which no device operation
ran, in percent."""


def read(run):
    t = run.trace
    if t is None or not t.ops or not t.span_s("prove"):  # nothing ran on a device
        return None
    return 100.0 * (1.0 - t.busy_in("prove") / t.span_s("prove"))
