"""Table kernels of the sumcheck prover and MLE evaluation.

Counterpart of ``zk_tpu.sumcheck.capacity``.  Five wrappers, each of a
hand-written CUDA kernel in csrc/capacity.cu, with the plain torch version
of the same function beside it:

  * ``fold_multi``    (replaces ``_fold_multi_cap``): fold f <= 4 MSB
    variables of a table's live prefix in one pass;
  * ``round_sums``    (replaces ``_round_sums_cap``): all D+1 round-poly
    sums of a k-factor product;
  * ``fold_halfsums`` (replaces ``_fold_halfsums_cap``): the fused
    degree-1 round, fold at r plus the folded table's two half sums;
  * ``fold``          (replaces ``_fold_cap``): fold every factor of a
    stack at r;
  * ``round_sums_terms`` (replaces ``_round_sums_terms_cap``): all D+1
    round-poly sums of a sum of products, every term in one pass.

A stack is a ``(k, L, cap)`` int32 tensor whose live prefix ``[0, size)``
of every row holds the table (``size`` a power of two).  A fold writes
its output to ``out``: the stack itself (in place over the prefix) or a
fresh buffer.  A wrapper
runs the plain version for CPU tensors and launches its kernel for CUDA
tensors; there is no other fallback.  Each kernel's ``*_args`` builds its
launch arguments from data pointers, for the wrapper and for the round
record (``sumcheck.record``), which launches with pointers it took once.

Sums come back as ``(P, L, G)`` int64 partial accumulators: partial g
holds the raw limb sums, over the pair indices of chunk g (see
``partition``), of the Montgomery representatives at each point.  The
kernel and the plain version produce bit-identical partials (integer
sums are exact in any order); ``kernels.canon_sums`` and
``kernels.decode_sums`` turn them into field elements.
"""

from __future__ import annotations

import torch

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch import _cuda
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.kernels import check_cuda, cuda_stream, params_ptr

THREADS = 256  # csrc/capacity.cu THREADS
MAX_PARTIALS = 1024  # blocks (= partial accumulators) of a sums kernel
MAX_DEGREE = 3
# (degree, factors) instantiated in csrc/capacity.cu
ROUND_SUMS_SHAPES = ((1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3))
# (degree, factors per term) instantiated in csrc/capacity.cu: the GKR
# phase polynomials ((2, 1), (2, 2)) and the dense layer polynomial (2, 3)
ROUND_SUMS_TERMS_SHAPES = ((2, (2, 1)), (2, (2, 2)), (2, (2, 3)))
FOLD_MAX_FACTORS = 5


def partition(n: int, n_terms: int = 1) -> tuple[int, int]:
    """(G, chunk): partial g of a sums kernel owns the pair indices
    [g * chunk, (g + 1) * chunk) of n.  Each of THREADS threads adds, for
    each of at most ceil(chunk / THREADS) pairs, n_terms limbs < 2^16 to
    a u32 accumulator, which is exact while that count is <= 2^16."""
    G = max(1, min(MAX_PARTIALS, -(-n // THREADS)))
    chunk = -(-n // G)
    if -(-chunk // THREADS) * n_terms > 1 << 16:
        raise ValueError(f"{n} pairs of {n_terms} terms exceed the u32 accumulator bound")
    return G, chunk


def _partials_plain(contrib: torch.Tensor, n_terms: int = 1) -> torch.Tensor:
    """(P, L, n) per-pair limb contributions -> (P, L, G) int64 partials,
    grouped exactly as the kernel's blocks are."""
    P, L, n = contrib.shape
    G, chunk = partition(n, n_terms)
    c = contrib.long()
    if G * chunk > n:
        c = torch.cat([c, c.new_zeros((P, L, G * chunk - n))], dim=-1)
    return c.reshape(P, L, G, chunk).sum(-1)


def _check_stack(field: Field, stack: torch.Tensor, size: int, name: str):
    L = field.n_limbs
    if stack.dtype != torch.int32:
        raise TypeError(f"{name}: stack must be int32 limbs, got {stack.dtype}")
    if stack.dim() != 3 or stack.shape[1] != L:
        raise ValueError(f"{name}: stack must be (k, {L}, cap), got {tuple(stack.shape)}")
    if size < 2 or size & (size - 1) or size > stack.shape[2]:
        raise ValueError(f"{name}: size {size} must be a power of two in [2, cap]")


def _check_out(stack, out, n_out: int, name: str):
    if out.dtype != torch.int32 or out.dim() != 3 or out.shape[:2] != stack.shape[:2]:
        raise ValueError(f"{name}: out must be int32 {tuple(stack.shape[:2])} + (cap,)")
    if out.shape[2] < n_out:
        raise ValueError(f"{name}: out holds {out.shape[2]} < {n_out} elements")
    if out.data_ptr() != stack.data_ptr() and _overlaps(stack, out):
        raise ValueError(f"{name}: out overlaps the stack without being it")


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    a1 = a0 + a.numel() * a.element_size()
    b1 = b0 + b.numel() * b.element_size()
    return a0 < b1 and b0 < a1


# --------------------------------------------------------------------------
# fold_multi
# --------------------------------------------------------------------------


def fold_multi_plain(field: Field, stack, size: int, rs, out):
    """Fold f = rs.shape[1] consecutive MSB variables of the (1, L, cap)
    prefix: out[0, :, :size >> f] (same result as f separate var-0 folds)."""
    x = stack[0, :, :size]
    for l in range(rs.shape[1]):
        h = x.shape[1] // 2
        x = dev.lerp(field, x[:, :h], x[:, h:], rs[:, l : l + 1])
    out[0, :, : size >> rs.shape[1]] = x
    return out


def fold_multi_args(field: Field, f: int, src: int, src_cap: int, dst: int, dst_cap: int, n_out: int, rs: int,
                    stream):
    """zk_fold_multi's arguments, from data pointers and row capacities."""
    return (field.n_limbs, f, src, src_cap, dst, dst_cap, n_out, rs, params_ptr(field), stream)


def fold_multi(field: Field, stack, size: int, rs, out):
    """Fold f = rs.shape[1] (1..4) MSB variables of the live prefix of a
    (1, L, cap) stack in one pass; rs is (L, f) int32 Montgomery scalars,
    column l the scalar of variable l.  Writes out[0, :, :size >> f] (out
    may be the stack itself) and returns out.  Replaces
    zk_tpu/sumcheck/capacity.py::_fold_multi_cap."""
    _check_stack(field, stack, size, "fold_multi")
    f = rs.shape[1] if rs.dim() == 2 else -1
    if stack.shape[0] != 1 or not 1 <= f <= 4 or rs.shape[0] != field.n_limbs:
        raise ValueError("fold_multi: needs a (1, L, cap) stack and (L, f) scalars, 1 <= f <= 4")
    if rs.dtype != torch.int32 or size < (1 << f):
        raise ValueError("fold_multi: int32 scalars and size >= 2^f required")
    n_out = size >> f
    _check_out(stack, out, n_out, "fold_multi")
    if stack.device.type == "cpu":
        return fold_multi_plain(field, stack, size, rs, out)
    check_cuda(field, "fold_multi", stack, rs, out)
    err = _cuda.lib().zk_fold_multi(*fold_multi_args(
        field, f, stack.data_ptr(), stack.shape[2], out.data_ptr(), out.shape[2], n_out, rs.data_ptr(),
        cuda_stream(stack),
    ))
    _cuda.check(err, "fold_multi")
    _cuda.count_launch("fold_multi")
    return out


# --------------------------------------------------------------------------
# round_sums
# --------------------------------------------------------------------------


def round_sums_plain(field: Field, degree: int, stack, size: int):
    """(D+1, L, G) int64 partials of the round-poly sums at 0..D of the
    product of the k factors of a (k, L, cap) stack (prover.rs:49-56)."""
    return round_sums_terms_plain(field, degree, (stack.shape[0],), stack, size)


def round_sums_args(field: Field, degree: int, k: int, src: int, cap: int, size: int, partials: int, stream):
    """zk_round_sums's arguments: the G = partition(size / 2) partials."""
    G, chunk = partition(size // 2)
    L = field.n_limbs
    return (L, degree, k, src, L * cap, cap, size // 2, chunk, G, params_ptr(field), partials, stream)


def round_sums(field: Field, degree: int, stack, size: int):
    """All D+1 round-polynomial sums over the live prefix [0, size) of a
    (k, L, cap) stack, as (D+1, L, G) int64 partial accumulators.  Points
    0 and 1 take the halves (no multiply); point i >= 2 lerps at i.
    Replaces zk_tpu/sumcheck/capacity.py::_round_sums_cap."""
    _check_stack(field, stack, size, "round_sums")
    k = stack.shape[0]
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"round_sums: degree {degree} not in 1..{MAX_DEGREE}")
    if stack.device.type == "cpu":
        return round_sums_plain(field, degree, stack, size)
    check_cuda(field, "round_sums", stack)
    if (degree, k) not in ROUND_SUMS_SHAPES:
        raise ValueError(f"round_sums: no kernel for (degree, k) = {(degree, k)}")
    G = partition(size // 2)[0]
    partials = torch.empty((degree + 1, field.n_limbs, G), dtype=torch.int64, device=stack.device)
    err = _cuda.lib().zk_round_sums(*round_sums_args(
        field, degree, k, stack.data_ptr(), stack.shape[2], size, partials.data_ptr(), cuda_stream(stack)
    ))
    _cuda.check(err, "round_sums")
    _cuda.count_launch("round_sums")
    return partials


# --------------------------------------------------------------------------
# round_sums_terms
# --------------------------------------------------------------------------


def round_sums_terms_plain(field: Field, degree: int, term_ks, stack, size: int):
    """(D+1, L, G) int64 partials of the round-poly sums at 0..D of a sum of
    products: rows [0, k_0) of the (sum(term_ks), L, cap) stack are the
    first term's factors, the next k_1 rows the second's, and so on.  Each
    term's product adds its limbs into the same partials, as in the
    kernel."""
    half = size // 2
    contrib = []
    for point in range(degree + 1):
        total, row = None, 0
        for k in term_ks:
            prod = None
            for _ in range(k):
                left, right = stack[row, :, :half], stack[row, :, half:size]
                if point == 0:
                    ev = left
                elif point == 1:
                    ev = right
                else:
                    ev = dev.lerp(field, left, right, dev.cached_const(field, point, True, stack.device))
                prod = ev if prod is None else dev.mont_mul(field, prod, ev)
                row += 1
            total = prod.long() if total is None else total + prod
        contrib.append(total)
    return _partials_plain(torch.stack(contrib), len(term_ks))


def round_sums_terms_args(field: Field, degree: int, term_ks, src: int, cap: int, size: int, partials: int,
                         stream):
    """zk_round_sums_terms's arguments: the G = partition(size / 2, terms)
    partials."""
    G, chunk = partition(size // 2, len(term_ks))
    L = field.n_limbs
    return (L, degree, term_ks[0], term_ks[1], src, L * cap, cap, size // 2, chunk, G,
            params_ptr(field), partials, stream)


def round_sums_terms(field: Field, degree: int, term_ks, stack, size: int):
    """All D+1 round-polynomial sums of a sum of products over the live
    prefix [0, size) of a (sum(term_ks), L, cap) stack, as (D+1, L, G)
    int64 partial accumulators: per pair, the sum over the terms of the
    product of their factors.  Replaces
    zk_tpu/sumcheck/capacity.py::_round_sums_terms_cap."""
    _check_stack(field, stack, size, "round_sums_terms")
    term_ks = tuple(term_ks)
    if not term_ks or min(term_ks) < 1 or sum(term_ks) != stack.shape[0]:
        raise ValueError(f"round_sums_terms: term sizes {term_ks} do not split {stack.shape[0]} rows")
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"round_sums_terms: degree {degree} not in 1..{MAX_DEGREE}")
    if stack.device.type == "cpu":
        return round_sums_terms_plain(field, degree, term_ks, stack, size)
    check_cuda(field, "round_sums_terms", stack)
    if (degree, term_ks) not in ROUND_SUMS_TERMS_SHAPES:
        raise ValueError(f"round_sums_terms: no kernel for (degree, term_ks) = {(degree, term_ks)}")
    G = partition(size // 2, len(term_ks))[0]
    partials = torch.empty((degree + 1, field.n_limbs, G), dtype=torch.int64, device=stack.device)
    err = _cuda.lib().zk_round_sums_terms(*round_sums_terms_args(
        field, degree, term_ks, stack.data_ptr(), stack.shape[2], size, partials.data_ptr(), cuda_stream(stack)
    ))
    _cuda.check(err, "round_sums_terms")
    _cuda.count_launch("round_sums_terms")
    return partials


def term_sums(field: Field, degree: int, ks, stack, size: int):
    """Round sums of the terms ks laid out in one stack: the k-factor
    product kernel for one term, the sum-of-products kernel otherwise."""
    if len(ks) == 1:
        return round_sums(field, degree, stack, size)
    return round_sums_terms(field, degree, ks, stack, size)


# --------------------------------------------------------------------------
# fold
# --------------------------------------------------------------------------


def fold_plain(field: Field, stack, size: int, r, out):
    half = size // 2
    for t in range(stack.shape[0]):
        out[t, :, :half] = dev.lerp(field, stack[t, :, :half], stack[t, :, half:size], r)
    return out


def fold_args(field: Field, k: int, src: int, src_cap: int, dst: int, dst_cap: int, size: int, r: int, stream):
    """zk_fold's arguments, from data pointers and row capacities."""
    L = field.n_limbs
    return (L, k, src, L * src_cap, src_cap, dst, L * dst_cap, dst_cap, size // 2, r,
            params_ptr(field), stream)


def fold(field: Field, stack, size: int, r, out):
    """Fold every factor of the live prefix of a (K, L, cap) stack at r
    ((L, 1) int32 Montgomery): out[t, :, e] = lerp(stack[t, :, e],
    stack[t, :, e + size/2], r) for e < size/2.  out may be the stack
    itself (in place over the prefix) or a fresh buffer; returns out.
    Replaces zk_tpu/sumcheck/capacity.py::_fold_cap."""
    _check_stack(field, stack, size, "fold")
    if r.dtype != torch.int32 or tuple(r.shape) != (field.n_limbs, 1):
        raise ValueError("fold: r must be (L, 1) int32")
    half = size // 2
    _check_out(stack, out, half, "fold")
    if stack.device.type == "cpu":
        return fold_plain(field, stack, size, r, out)
    check_cuda(field, "fold", stack, r, out)
    K = stack.shape[0]
    if K > FOLD_MAX_FACTORS:
        raise ValueError(f"fold: no kernel for {K} factors (at most {FOLD_MAX_FACTORS})")
    err = _cuda.lib().zk_fold(*fold_args(
        field, K, stack.data_ptr(), stack.shape[2], out.data_ptr(), out.shape[2], size, r.data_ptr(),
        cuda_stream(stack),
    ))
    _cuda.check(err, "fold")
    _cuda.count_launch("fold")
    return out


# --------------------------------------------------------------------------
# fold_halfsums
# --------------------------------------------------------------------------


def fold_halfsums_plain(field: Field, stack, size: int, r, out):
    half = size // 2
    x = dev.lerp(field, stack[0, :, :half], stack[0, :, half:size], r)
    out[0, :, :half] = x
    zero = torch.zeros_like(x)
    q = half // 2
    contrib = torch.stack(
        [torch.cat([x[:, :q], zero[:, q:]], 1), torch.cat([zero[:, :q], x[:, q:]], 1)]
    )
    return out, _partials_plain(contrib)


def fold_halfsums_args(field: Field, src: int, src_cap: int, dst: int, dst_cap: int, size: int, r: int,
                       partials: int, stream):
    """zk_fold_halfsums's arguments: the G = partition(size / 2) partials."""
    half = size // 2
    G, chunk = partition(half)
    return (field.n_limbs, src, src_cap, dst, dst_cap, half, chunk, G, r, params_ptr(field),
            partials, stream)


def fold_halfsums(field: Field, stack, size: int, r, out):
    """Fused degree-1 single-factor round: fold the (1, L, cap) prefix at
    r ((L, 1) int32 Montgomery) into out[0, :, :size/2] (out may be the
    stack itself), and return (out, (2, L, G) int64 partials of the folded
    table's two halves) — the next round's p(0) and p(1).  size >= 4.
    Replaces zk_tpu/sumcheck/capacity.py::_fold_halfsums_cap."""
    _check_stack(field, stack, size, "fold_halfsums")
    if stack.shape[0] != 1 or size < 4:
        raise ValueError("fold_halfsums: needs a (1, L, cap) stack and size >= 4")
    if r.dtype != torch.int32 or tuple(r.shape) != (field.n_limbs, 1):
        raise ValueError("fold_halfsums: r must be (L, 1) int32")
    half = size // 2
    _check_out(stack, out, half, "fold_halfsums")
    if stack.device.type == "cpu":
        return fold_halfsums_plain(field, stack, size, r, out)
    check_cuda(field, "fold_halfsums", stack, r, out)
    acc = torch.empty((2, field.n_limbs, partition(half)[0]), dtype=torch.int64, device=stack.device)
    err = _cuda.lib().zk_fold_halfsums(*fold_halfsums_args(
        field, stack.data_ptr(), stack.shape[2], out.data_ptr(), out.shape[2], size, r.data_ptr(),
        acc.data_ptr(), cuda_stream(stack),
    ))
    _cuda.check(err, "fold_halfsums")
    _cuda.count_launch("fold_halfsums")
    return out, acc
