"""The benchmark's fixed measures: the card's peaks and the work of a prove,
frozen here so that a change to the program cannot move them.

Copied from chip_smoke.py (HBM_BYTES_PER_S, IMAD_PER_S, mont_imads) and
zk_tpu_torch/utils/stat.py (mle_eval_mults, sumcheck_prover_mults) at the
commit that added the benchmark.
"""

from __future__ import annotations

# H100 SXM HBM3 bandwidth (NVIDIA H100 data sheet): 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer multiply-adds: 64 per clock per SM on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput),
# 132 SMs at the 1.98 GHz boost clock
IMAD_PER_S = 64 * 132 * 1.98e9


def mont_imads(n_limbs16: int) -> int:
    """32-bit multiply-adds of one CIOS Montgomery product over n_limbs16
    16-bit limbs (zk_tpu_torch/csrc/field.cuh works on NW = n_limbs16 / 2
    32-bit words): 2 NW^2 word products, each 2 IMADs (low and high)."""
    nw = n_limbs16 // 2
    return 4 * nw * nw


def mle_eval_mults(n_vars: int) -> int:
    """Field products of a full n-variable MLE evaluation: one per index
    pair, summed over the halving folds (evaluation_form.rs:68)."""
    return (1 << n_vars) - 1


def sumcheck_prover_mults(n_vars: int, degree: int, k: int) -> int:
    """Field products of the upstream prover's round loop (prover.rs:44-68):
    per round on a table of s entries, (degree - 1) speculative folds and
    k - 1 products at each of degree + 1 points per pair, and the real
    fold, summed over the halving rounds."""
    total = 0
    s = 1 << n_vars
    while s > 1:
        half = s // 2
        total += (degree - 1) * k * half + (k - 1) * half * (degree + 1) + k * half
        s = half
    return total


def sumcheck_needed_mults(n_vars: int, degree: int, k: int) -> int:
    """Field products a prove of a k-factor product at this degree cannot
    avoid: per pair, k - 1 products at each of degree + 1 points (a
    factor's value at t >= 2 is lo + t (hi - lo), additions only) and k
    folds at the challenge, except after the last round.  At most
    ``sumcheck_prover_mults``; the roofline counts these."""
    total = 0
    s = 1 << n_vars
    while s > 1:
        half = s // 2
        total += (k - 1) * (degree + 1) * half + (k * half if half > 1 else 0)
        s = half
    return total


def sumcheck_least_seconds(n_vars: int, degree: int, k: int, n_limbs16: int) -> float:
    """The least time a card at its peaks could take for one prove: the
    larger of its statement's bytes read once (4 bytes a 16-bit limb, as
    the program holds them) over the HBM rate and its needed products'
    multiply-adds over the IMAD rate."""
    t_bytes = k * n_limbs16 * 4 * (1 << n_vars) / HBM_BYTES_PER_S
    t_ops = sumcheck_needed_mults(n_vars, degree, k) * mont_imads(n_limbs16) / IMAD_PER_S
    return max(t_bytes, t_ops)
