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


def matmul_layers(n: int) -> list[tuple[int, int, int, int]]:
    """The shape of the n x n matrix-multiplication circuit, output layer
    first: per layer (gates, mul gates, k_out, k_in).  One layer of n^3
    products over 2 n^2 inputs, under log2 n layers of pairwise sums."""
    lg = n.bit_length() - 1
    adds = [(1 << k, 0, k, k + 1) for k in range(2 * lg, 3 * lg)]
    return adds + [(n**3, n**3, 3 * lg, 2 * lg + 1)]


def _eq_mults(k: int) -> int:
    """Products of an eq table on k variables by doubling: a step on a
    table of s > 1 entries takes s products (the first step's entries are
    1 - r and r): 2^k - 2."""
    return max((1 << k) - 2, 0)


def gkr_needed_mults(layers: list[tuple[int, int, int, int]]) -> int:
    """Field products a GKR prove of a layered add/mul circuit cannot avoid
    (Libra's linear-time prover), from each layer's gates G, mul gates M,
    k_out and k_in (s = 2^k_in):

      the output claim W_0(r)             2^k_0 - 1 (a fold chain)
      per layer:
        the witness                       M (one product a mul gate)
        eq(r) and eq(u)                   _eq_mults(k_out) + _eq_mults(k_in)
        the phase tables                  G for phase 1 (eq(r, a) W(right))
                                          and G for phase 2 (eq(r, a) eq(u, left))
        phase 1, G1 W + A2, per pair      3 (G1 W at t = 0, 1, 2; a factor at
                                          t = 2 is lo + 2 (hi - lo), additions)
                                          and 3 folds (G1, W, A2) but after
                                          the last round: 3 (s - 1) + 3 (s - 2)
        phase 2, add_u (W(u) + W) +       6 (two products at three points),
        W(u) mul_u W, per pair            3 folds (add_u, mul_u, W) but after
                                          the last round, and W(u) times the
                                          round's three sums: 6 (s - 1) +
                                          3 (s - 2) + 3 k_in
        the line q(t) = W(u + t (v - u))  folding W at u_j + t d_j keeps an
                                          entry's j + 1 coefficients in t:
                                          sum_j 2^(k_in - j) (j + 1)

    The count is the protocol's, whatever implements it."""
    total = (1 << layers[0][2]) - 1
    for g, m, k_out, k_in in layers:
        s = 1 << k_in
        total += m + _eq_mults(k_out) + _eq_mults(k_in) + 2 * g
        total += 3 * (s - 1) + 3 * (s - 2)
        total += 6 * (s - 1) + 3 * (s - 2) + 3 * k_in
        total += sum((1 << (k_in - j)) * (j + 1) for j in range(k_in))
    return total


def gkr_bytes(layers: list[tuple[int, int, int, int]], n_limbs16: int) -> int:
    """Bytes a GKR prove reads or writes at least once (4 bytes a 16-bit
    limb, as the program holds them): every level's wire values, and per
    layer the eq(r) table, the four phase tables (G1, A2, add_u, mul_u)
    and the eq(u) table; and the wiring, two 4-byte indices a gate."""
    elem = 4 * n_limbs16
    total = sum(elem << k_out for _, _, k_out, _ in layers) + (elem << layers[-1][3])
    for g, _, k_out, k_in in layers:
        total += elem * ((1 << k_out) + 5 * (1 << k_in)) + 8 * g
    return total


def gkr_least_seconds(layers: list[tuple[int, int, int, int]], n_limbs16: int) -> float:
    """The least time a card at its peaks could take for one GKR prove: the
    larger of ``gkr_bytes`` over the HBM rate and ``gkr_needed_mults``'
    multiply-adds over the IMAD rate."""
    return max(gkr_bytes(layers, n_limbs16) / HBM_BYTES_PER_S,
               gkr_needed_mults(layers) * mont_imads(n_limbs16) / IMAD_PER_S)
