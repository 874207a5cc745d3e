"""Mean seconds of a job's verify steps (deserialize, verify, the ranks'
oracle evaluations and their hand-off) over the jobs of a traced window:
``verify_s`` read per layer in the four-card cell, whose verify steps
spread across runs too widely for any bound the benchmark allows."""


def read(run):
    spans = run.spans("verify")
    return sum(e - s for s, e in spans) / len(run.jobs) if run.jobs else None
