"""Mean seconds of a job's verify steps (deserialize, verify, oracle
evaluation), over every job of the window."""


def read(run):
    spans = run.spans("verify")
    return sum(e - s for s, e in spans) / len(run.jobs) if run.jobs else None
