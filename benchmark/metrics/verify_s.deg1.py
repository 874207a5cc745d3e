"""Mean seconds of a job's verify steps (deserialize, verify, oracle
evaluation) over the jobs of a traced window: ``verify_s`` read per layer,
in the cells whose runs spread too widely for it to be guarded end to
end."""


def read(run):
    spans = run.spans("verify")
    return sum(e - s for s, e in spans) / len(run.jobs) if run.jobs else None
