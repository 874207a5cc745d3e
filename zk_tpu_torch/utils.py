"""Analytic field-op counters, shared with the reference package."""

from zk_tpu.utils import mle_eval_mults, sumcheck_prover_mults  # noqa: F401
