"""PERF_LOG scope timers and analytic op counters (``utils.stat``)."""

from zk_tpu_torch.utils.stat import (  # noqa: F401
    end_timer,
    mle_eval_mults,
    start_timer,
    sumcheck_prover_mults,
    timer,
)
