"""Field products per second of the verifier's oracle evaluations
(MLE.evaluate of each factor, host clock around each call, which ends in
its read-back): mle_eval_mults(n_vars) per call over the calls' time."""

from benchmark import yardstick as Y


def read(run):
    if run.cell.config["job"] != "sumcheck":
        return None
    spans = run.spans("oracle_eval")
    secs = sum(e - s for s, e in spans)
    return Y.mle_eval_mults(run.cell.config["n_vars"]) * len(spans) / secs if secs > 0 else None
