"""Analytic field-op counters (the port's copy of ``zk_tpu.utils.stat``'s):
the op counts are deterministic functions of (n, degree, k)."""


def mle_eval_mults(n_vars: int) -> int:
    """Field mults for a full n-var MLE evaluation: one per index pair
    (evaluation_form.rs:68) summed over the shrinking fold."""
    return (1 << n_vars) - 1


def sumcheck_prover_mults(n_vars: int, degree: int, k: int) -> int:
    """Field mults for the sumcheck prover round loop (prover.rs:44-68):
    per round on a size-s table, (degree-1) speculative lerp folds (the
    0/1 points are multiplication-free) + k-1 prod_reduce mults per
    element + the real fold, summed over halving rounds."""
    total = 0
    s = 1 << n_vars
    while s > 1:
        half = s // 2
        total += (degree - 1) * k * half + (k - 1) * half * (degree + 1) + k * half
        s = half
    return total
