"""Device tier for GKR: eq expansion, witness evaluation, the linear-time
(Libra-style) two-phase layer tables, the line restriction and the
wiring predicates, on (L, N) int32 Montgomery limb tensors.

Counterpart of ``zk_tpu.gkr.device``.  The layer sum

  sum_{b,c} add~(r,b,c) * (W(b) + W(c)) + mul~(r,b,c) * W(b) * W(c)

is proven as two chained k-round sumchecks over tables of 2^k entries
built from the sparse wiring in O(gates):

  phase 1 (sum over b):   G1(b) * W(b) + A2(b)
      G1(b) = sum_c add~(r,b,c) + sum_c mul~(r,b,c) W(c)
      A2(b) = sum_c add~(r,b,c) W(c)
  phase 2 (sum over c, b fixed at u):
      add_u(c) * (W(u) + W(c)) + [mul_u(c) * W(u)] * W(c)

The round polynomials equal the dense O(4^k) prover's (``GKRProver.
prove_dense``).  A wiring table is a scatter-add: an int64 ``index_add_``
of raw limbs, then one renormalisation (``fields.device.renorm_relaxed``),
exact in any order; it gives the same integers as both of the reference's
strategies (its scatter and its fan-in gather plan).
"""

from __future__ import annotations

import torch

from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.fields.kernels import mont_mul
from zk_tpu_torch.parallel.mesh import MeshGroup
from zk_tpu_torch.poly.mle import MLE, fold_var0
from zk_tpu_torch.poly.product import ProductPoly, SumOfProducts

# --------------------------------------------------------------------------
# eq table + point evaluation
# --------------------------------------------------------------------------


def _one(field: Field, device) -> torch.Tensor:
    """Montgomery 1 as an (L, 1) column, cached on its device."""
    return dev.cached_const(field, 1, True, torch.device(device))


def _eq_expand(field: Field, rs: torch.Tensor) -> torch.Tensor:
    """rs: (k, L) Montgomery rows -> (L, 2^k) table of eq(r, a) =
    prod_j (r_j a_j + (1-r_j)(1-a_j)), var 0 = index MSB.  Iterated
    doubling, LSB-first, so each step prepends the next-more-significant
    bit: k steps, 2^k Montgomery products in all."""
    x = _one(field, rs.device)
    for j in range(rs.shape[0] - 1, -1, -1):
        right = dev.mont_mul(field, x, rs[j].reshape(-1, 1))
        x = torch.cat([dev.sub_mod(field, x, right), right], dim=-1)
    return x


def _mont_rs(field: Field, point: list[int], device) -> torch.Tensor:
    """Host ints -> (k, L) Montgomery rows (one upload)."""
    return dev.encode_ints(field, point, device=device).t().contiguous()


def eq_table(field: Field, point: list[int], device) -> torch.Tensor:
    """eq(point, .) over the 2^k hypercube as (L, 2^k) Montgomery limbs."""
    if not point:
        return _one(field, device)
    return _eq_expand(field, _mont_rs(field, point, device))


def mle_eval_points(field: Field, data: torch.Tensor, points: list[list[int]]) -> torch.Tensor:
    """Evaluate one (L, 2^n) table at each point (host ints); returns (L, P)
    Montgomery limbs on the table's device.  Each point is one chain of
    fold_multi passes (``poly.mle.fold_var0``)."""
    if data.shape[-1] == 1:
        return data.reshape(field.n_limbs, 1).expand(-1, len(points)).contiguous()
    outs = [fold_var0(field, data, dev.encode_ints(field, pt, device=data.device)) for pt in points]
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# line restriction: q(t) = W~(b + t(c - b)) in one symbolic fold pass
# --------------------------------------------------------------------------


def _line_fold(field: Field, data: torch.Tensor, bs: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """Restrict an (L, 2^k) table to the line l(t) = b + t d: returns the
    (L, k+1) Montgomery coefficients of the degree-<=k univariate
    q(t) = W~(l(t)) (zk_tpu.gkr.device._line_fold_kernel).  bs, ds: (k, L)
    Montgomery rows.  Each fold level substitutes l_j(t) for variable j,
    so entries become polynomials in t (degree axis last): new_d = left_d
    + b_j diff_d + d_j diff_{d-1}.  Same pairing order as the evaluation
    fold (var 0 = MSB), so values equal per-point evaluation."""
    L = field.n_limbs
    x = data.reshape(L, -1, 1)
    for j in range(bs.shape[0]):
        half = x.shape[1] // 2
        left, right = x[:, :half], x[:, half:]
        diff = dev.sub_mod(field, right, left)
        t0 = dev.add_mod(field, left, dev.mont_mul(field, diff, bs[j].reshape(L, 1, 1)))
        t1 = dev.mont_mul(field, diff, ds[j].reshape(L, 1, 1))
        zero = torch.zeros_like(t0[:, :, :1])
        x = dev.add_mod(field, torch.cat([t0, zero], dim=2), torch.cat([zero, t1], dim=2))
    return x[:, 0, :]


def line_restriction_evals(field: Field, w_dev: torch.Tensor, b: list[int], c: list[int]) -> list[int]:
    """q(t) = W~(b + t(c - b)) at t = 0..k (the layer proof's q_evals;
    q(0) = W(b), q(1) = W(c)): one symbolic fold on the device, one small
    decode, then k+1 Horner chains on host ints."""
    if not b:
        return dev.decode_ints(field, w_dev.reshape(field.n_limbs, 1))
    ds = [(cj - bj) % field.p for bj, cj in zip(b, c)]
    d = w_dev.device
    cs = dev.decode_ints(field, _line_fold(field, w_dev, _mont_rs(field, b, d), _mont_rs(field, ds, d)))
    out = []
    for t in range(len(b) + 1):
        acc = 0
        for coeff in reversed(cs):
            acc = (acc * t + coeff) % field.p
        out.append(acc)
    return out


# --------------------------------------------------------------------------
# witness: circuit evaluation on the device
# --------------------------------------------------------------------------


def _layer_eval(field: Field, pad_to: int, cur, left, right, is_add) -> torch.Tensor:
    """One circuit layer: gather the children, add or multiply mod p by
    gate op, zero-pad the output vector to pad_to."""
    lv, rv = cur[:, left], cur[:, right]
    vals = torch.where(is_add, dev.add_mod(field, lv, rv), dev.mont_mul(field, lv, rv))
    return torch.nn.functional.pad(vals, (0, pad_to - vals.shape[-1]))


def _layer_eval_sharded(field: Field, group, pad_to: int, cur, circuit, layer: int) -> torch.Tensor:
    """One circuit layer over a mesh: this rank evaluates the gates
    [d pad_to/D, (d+1) pad_to/D) of the wiring padded to pad_to (padded
    slots masked to zero, as _layer_eval's padding), and one
    ``all_gather`` re-replicates the level for the next layer's gathers."""
    key = ("sharded", layer, group.size, group.index, cur.device)
    wired = circuit._dev_cache.get(key)
    if wired is None:
        left, right, is_add = circuit.device_wiring(layer, "cpu")
        chunk = pad_to // group.size
        gate = torch.arange(group.index * chunk, (group.index + 1) * chunk)
        valid = gate < left.shape[0]
        gate = torch.where(valid, gate, 0)  # padded slots evaluate gate 0, then are masked
        wired = tuple(a.to(cur.device) for a in (left[gate], right[gate], is_add[gate], valid))
        circuit._dev_cache[key] = wired
    left, right, is_add, valid = wired
    lv, rv = cur[:, left], cur[:, right]
    vals = torch.where(is_add, dev.add_mod(field, lv, rv), mont_mul(field, lv, rv))
    vals = torch.where(valid, vals, torch.zeros_like(vals))
    return group.all_gather(vals).permute(1, 0, 2).reshape(field.n_limbs, pad_to)


def evaluate_device(circuit, field: Field, inputs, device=None, mesh=None) -> list[torch.Tensor]:
    """Wire values per level as (L, 2^k) Montgomery tensors, output level
    first (the device analogue of Circuit.evaluate, the same padding).

    ``inputs`` is a list of host ints, encoded onto ``device`` (the card
    unless another is named), or an (L, n_inputs) Montgomery limb tensor,
    whose device is used: a witness already on the card never crosses the
    host link.  With a mesh (every rank calling with the same inputs),
    each layer whose padded width divides across the mesh is
    gate-sharded, one ``all_gather`` a layer; the values are the
    single-device ones."""
    pad_to = 1 << circuit.layer_k(circuit.depth)
    if isinstance(inputs, torch.Tensor):
        if tuple(inputs.shape) != (field.n_limbs, circuit.n_inputs):
            raise ValueError(
                f"device inputs must be ({field.n_limbs}, {circuit.n_inputs}) Montgomery limbs, "
                f"got {tuple(inputs.shape)}"
            )
        cur = torch.nn.functional.pad(inputs, (0, pad_to - circuit.n_inputs))
    else:
        if len(inputs) != circuit.n_inputs:
            raise ValueError("wrong number of inputs")
        padded = list(inputs) + [0] * (pad_to - len(inputs))
        cur = dev.encode_ints(field, padded, device=dev.resolve_device(device))
    group = None if mesh is None else MeshGroup(mesh)
    levels: list = [None] * (circuit.depth + 1)
    levels[circuit.depth] = cur
    for i in range(circuit.depth - 1, -1, -1):
        pad_to = 1 << circuit.layer_k(i)
        if group is not None and pad_to % group.size == 0:
            cur = _layer_eval_sharded(field, group, pad_to, cur, circuit, i)
        else:
            cur = _layer_eval(field, pad_to, cur, *circuit.device_wiring(i, cur.device))
        levels[i] = cur
    return levels


# --------------------------------------------------------------------------
# Libra phase tables
# --------------------------------------------------------------------------


def scatter_table(field: Field, size: int, pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Scatter-add (L, G) Montgomery values into a zeroed (L, size) table at
    the int64 positions ``pos`` and renormalise mod p: duplicate positions
    add exactly (raw int64 limb sums, then one renorm)."""
    acc = torch.zeros((field.n_limbs, size), dtype=torch.int64, device=vals.device)
    acc.index_add_(1, pos, vals.long())
    return dev.renorm_relaxed(field, acc)


def phase1_tables(field: Field, circuit, layer: int, eq_r, w_dev):
    """(G1, A2), each (L, 2^k_in).  G1 scatters at b = left the values
    eq_r(a) (add gates) or eq_r(a) W(right) (mul gates); A2 scatters
    eq_r(a) W(right) for add gates only."""
    left, right, is_add = circuit.device_wiring(layer, w_dev.device)
    size = 1 << circuit.layer_k(layer + 1)
    wgt = eq_r[:, : left.shape[0]]
    wgt_wr = dev.mont_mul(field, wgt, w_dev[:, right])
    g1 = scatter_table(field, size, left, torch.where(is_add, wgt, wgt_wr))
    a2 = scatter_table(field, size, left, torch.where(is_add, wgt_wr, torch.zeros_like(wgt_wr)))
    return g1, a2


def phase2_tables(field: Field, circuit, layer: int, eq_r, eq_u, w_dev, wu):
    """(add_u, mul_u W(u), W(u) + W), each (L, 2^k_in): add_u(c) = add~(r,
    u, c) and mul_u(c) = mul~(r, u, c) scatter eq_r(a) eq_u(left) at
    c = right, by gate op; wu is W(u) as an (L, 1) column."""
    left, right, is_add = circuit.device_wiring(layer, w_dev.device)
    size = 1 << circuit.layer_k(layer + 1)
    w2 = dev.mont_mul(field, eq_r[:, : left.shape[0]], eq_u[:, left])
    zeros = torch.zeros_like(w2)
    add_u = scatter_table(field, size, right, torch.where(is_add, w2, zeros))
    mul_u = scatter_table(field, size, right, torch.where(is_add, zeros, w2))
    return add_u, dev.mont_mul(field, mul_u, wu), dev.add_mod(field, w_dev, wu)


def build_phase1(field: Field, circuit, layer: int, eq_r, w_dev) -> SumOfProducts:
    """Phase-1 polynomial over b: G1(b) W(b) + A2(b)."""
    k_in = circuit.layer_k(layer + 1)
    g1, a2 = phase1_tables(field, circuit, layer, eq_r, w_dev)
    w = MLE(field, k_in, w_dev)
    return SumOfProducts([ProductPoly([MLE(field, k_in, g1), w]), ProductPoly([MLE(field, k_in, a2)])])


def build_phase2(field: Field, circuit, layer: int, eq_r, u: list[int], w_dev):
    """Phase-2 polynomial over c (b fixed at u): add_u(c) (W(u) + W(c)) +
    [mul_u(c) W(u)] W(c); also returns W(u) as an (L, 1) column."""
    k_in = circuit.layer_k(layer + 1)
    wu = mle_eval_points(field, w_dev, [u])
    add_u, mul_u_s, w_shift = phase2_tables(
        field, circuit, layer, eq_r, eq_table(field, u, w_dev.device), w_dev, wu
    )
    poly = SumOfProducts([
        ProductPoly([MLE(field, k_in, add_u), MLE(field, k_in, w_shift)]),
        ProductPoly([MLE(field, k_in, mul_u_s), MLE(field, k_in, w_dev)]),
    ])
    return poly, wu


# --------------------------------------------------------------------------
# wiring predicates at a point (the verifier's oracle check)
# --------------------------------------------------------------------------


def wiring_eval_async(field: Field, circuit, layer: int, r, b, c, device) -> torch.Tensor:
    """(add~, mul~) of layer at (r, b, c) as an (L, 2) Montgomery tensor,
    not read back: per gate eq_r(a) eq_b(left) eq_c(right), summed by op."""
    left, right, is_add = circuit.device_wiring(layer, device)
    w = dev.mont_mul(field, eq_table(field, r, device)[:, : left.shape[0]], eq_table(field, b, device)[:, left])
    w = dev.mont_mul(field, w, eq_table(field, c, device)[:, right])
    zeros = torch.zeros_like(w)
    add_sum = dev.sum_mod(field, torch.where(is_add, w, zeros))
    mul_sum = dev.sum_mod(field, torch.where(is_add, zeros, w))
    return torch.stack([add_sum, mul_sum], dim=-1)


def wiring_eval(field: Field, circuit, layer: int, r, b, c, device) -> tuple[int, int]:
    """(add~_layer, mul~_layer) at (r, b, c) in O(gates): the same values as
    the host eq-sum (``gkr._wiring_eval_host``)."""
    vals = dev.decode_ints(field, wiring_eval_async(field, circuit, layer, r, b, c, device))
    return vals[0], vals[1]
