"""Mean seconds of a job's prove steps (prove and serialize), over every
job of the window: the sum of the prove spans over the job count."""


def read(run):
    spans = run.spans("prove")
    return sum(e - s for s, e in spans) / len(run.jobs) if run.jobs else None
