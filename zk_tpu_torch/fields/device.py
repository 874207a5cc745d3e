"""Torch limb tier: limb-decomposed Montgomery tensors (plain tensor code).

Counterpart of ``zk_tpu.fields.device``.  A field element is ``n_limbs``
base-2^16 limbs, **limb axis first**: N elements are an ``(L, N)`` tensor,
a scalar is ``(L,)`` or ``(L, 1)``.  Tables are stored as ``torch.int32``
(the limbs are < 2^16, so the bits equal the reference's uint32 arrays and
the CUDA kernels read the same buffers as ``uint32_t*``); every op here
computes in int64 and returns int32.  Values are in Montgomery form
(x * R mod p, R = 2^(16 L)); the encode/decode boundary converts.

Every result is the unique representative in [0, p), so these ops give the
same limbs as the reference's lo/hi-split code and as the CUDA kernels'
32-bit-word arithmetic (csrc/field.cuh) — R is the same in all three.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_tpu_torch.fields.field import Field, LIMB_BITS, LIMB_MASK
from zk_tpu_torch.utils.stat import to_host

_B = LIMB_BITS


# --------------------------------------------------------------------------
# constants
# --------------------------------------------------------------------------


def _int_to_limbs(value: int, n: int) -> np.ndarray:
    return np.array([(value >> (_B * i)) & LIMB_MASK for i in range(n)], dtype=np.uint32)


def p_limbs(field: Field) -> np.ndarray:
    """Modulus as a base-2^16 limb vector, shape (L,), uint32."""
    return _int_to_limbs(field.p, field.n_limbs)


def const_limbs(field: Field, value: int, mont: bool = True) -> np.ndarray:
    """Host int -> (L,) uint32 limb vector (Montgomery form by default)."""
    v = (value * field.R) % field.p if mont else value % field.p
    return _int_to_limbs(v, field.n_limbs)


def resolve_device(device) -> torch.device:
    """The device of a public entry point: the card unless the caller
    names another (``device="cpu"``).  Without a card, "cuda" raises at
    the first tensor; nothing falls back to the CPU."""
    return torch.device("cuda" if device is None else device)


def scalar(field: Field, value: int, *, device, mont: bool = True) -> torch.Tensor:
    """Host int -> (L, 1) int32 scalar for broadcasting."""
    limbs = const_limbs(field, value, mont=mont).astype(np.int32)
    return torch.from_numpy(limbs).reshape(field.n_limbs, 1).to(device)


@functools.lru_cache(maxsize=None)
def cached_const(field: Field, value: int, mont: bool, device: torch.device) -> torch.Tensor:
    """``scalar`` kept on its device: a constant uploaded once, so the
    prover's round loop copies nothing from the host."""
    return scalar(field, value, device=device, mont=mont)


@functools.lru_cache(maxsize=None)
def _p_col(field: Field, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(p_limbs(field).astype(np.int64)).to(device)


def _col(field: Field, x: torch.Tensor, ndim: int) -> torch.Tensor:
    """The modulus as an int64 (L, 1, ..., 1) column for ndim-dim tensors."""
    return _p_col(field, x.device).reshape((field.n_limbs,) + (1,) * (ndim - 1))


# --------------------------------------------------------------------------
# encode / decode (host boundary)
# --------------------------------------------------------------------------


def encode_ints(field: Field, values, *, device, mont: bool = True) -> torch.Tensor:
    """Python ints -> (L, N) int32 limb tensor (Montgomery form by default)."""
    p, L = field.p, field.n_limbs
    vals = [int(v) % p for v in values]
    if mont:
        R = field.R
        vals = [(v * R) % p for v in vals]
    packed = b"".join(v.to_bytes(2 * L, "little") for v in vals)
    limbs = np.frombuffer(packed, dtype="<u2").reshape(len(vals), L)
    return torch.from_numpy(np.ascontiguousarray(limbs.T.astype(np.int32))).to(device)


def _canonical(field: Field, t: torch.Tensor, mont: bool, out=None) -> torch.Tensor:
    """(L, N) limbs -> (L, N) int32 canonical limbs on t's device (in
    ``out`` if given).  Montgomery un-scaling is one product by the integer
    1 through the mont_mul kernel wrapper: one launch on a card (the limb
    tier takes a few hundred, which dominated a warm 2^24 MLE.evaluate),
    the plain version on the CPU.  Limbs may come in any integer dtype (a
    prover's host readback is int64)."""
    from zk_tpu_torch.fields import kernels  # the kernel layer imports this module

    t = t.reshape(field.n_limbs, -1).to(torch.int32).contiguous()
    if mont:
        one = cached_const(field, 1, False, t.device).expand(t.shape).contiguous()
        return kernels.mont_mul(field, t, one, out=out)
    return t if out is None else out.copy_(t)


def _rows(t: torch.Tensor) -> np.ndarray:
    """(L, N) limbs in a CPU tensor -> (N, L) uint16."""
    return np.ascontiguousarray(t.numpy().astype(np.uint16).T)


def limb_ints(field: Field, limbs: np.ndarray) -> list[int]:
    """Canonical limbs with the limb axis last ((..., L), any integer
    dtype) -> Python ints in the order of the other axes: one numpy pass
    to little-endian 16-bit words, then one ``int.from_bytes`` an
    element."""
    if limbs.shape[-1] != field.n_limbs:
        raise ValueError(f"limbs must be (..., {field.n_limbs}), got {limbs.shape}")
    data, w, from_bytes = np.ascontiguousarray(limbs, dtype="<u2").tobytes(), 2 * field.n_limbs, int.from_bytes
    return [from_bytes(data[j : j + w], "little") for j in range(0, len(data), w)]


def host_ints(field: Field, t: torch.Tensor, mont: bool = True) -> list[int]:
    """(L, N) limbs already read back (a CPU tensor) -> canonical Python
    ints, with no read of their own."""
    return limb_ints(field, _canonical(field, t, mont).numpy().T)


def decode_ints(field: Field, t: torch.Tensor, mont: bool = True) -> list[int]:
    """(L, N) limb tensor -> list of canonical Python ints: un-scaled where
    t lies, then one read."""
    return host_ints(field, to_host(_canonical(field, t, mont)), mont=False)


def decode_bytes_be(field: Field, t: torch.Tensor, mont: bool = True) -> bytes:
    """(L, N) limb tensor -> concatenated canonical BE bytes, n_bytes per
    element (evaluation_form.rs:97-103 / zk_tpu.fields.device)."""
    rows = _rows(to_host(_canonical(field, t, mont)))[:, ::-1].astype(">u2")  # MS limb first
    n, nb, w = rows.shape[0], field.n_bytes, 2 * field.n_limbs
    raw = np.frombuffer(rows.tobytes(), dtype=np.uint8).reshape(n, w)
    if w == nb:
        return raw.tobytes()
    buf = np.zeros((n, nb), dtype=np.uint8)
    keep = min(w, nb)
    buf[:, nb - keep :] = raw[:, w - keep :]
    return buf.tobytes()


def encode_bytes_be(field: Field, data: bytes, *, device, mont: bool = True) -> torch.Tensor:
    """Concatenated canonical BE bytes -> (L, N) int32 limb tensor."""
    nb, L = field.n_bytes, field.n_limbs
    if len(data) % nb:
        raise ValueError("byte string is not a whole number of elements")
    raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, nb)
    be16 = raw[:, nb - 2 * L :].copy().view(">u2")  # (n, L) most significant first
    limbs = be16.astype(np.int32)[:, ::-1].T
    out = torch.from_numpy(np.ascontiguousarray(limbs)).to(device)
    return to_mont(field, out) if mont else out


# --------------------------------------------------------------------------
# limb arithmetic (int64, vectorized over the element axes)
# --------------------------------------------------------------------------


def _carry(cols: torch.Tensor):
    """Relaxed int64 columns (C, *S), possibly negative -> (limbs in
    [0, 2^16), final carry (*S)).  ``&`` and arithmetic ``>>`` are exact
    mod-2^16 / floor-division on two's-complement int64."""
    out = torch.empty_like(cols)
    carry = None
    for i in range(cols.shape[0]):
        v = cols[i] if carry is None else cols[i] + carry
        out[i] = v & LIMB_MASK
        carry = v >> _B
    return out, carry


def _cond_sub_p(field: Field, limbs: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """value = limbs + top * R; subtract p once if value >= p."""
    diff, borrow = _carry(limbs - _col(field, limbs, limbs.ndim))
    return torch.where(top + borrow >= 0, diff, limbs)


def add_mod(field: Field, a, b) -> torch.Tensor:
    """Elementwise (a + b) mod p (inputs < p)."""
    limbs, carry = _carry(a.long() + b.long())
    return _cond_sub_p(field, limbs, carry).int()


def sub_mod(field: Field, a, b) -> torch.Tensor:
    """Elementwise (a - b) mod p (inputs < p)."""
    limbs, borrow = _carry(a.long() - b.long())
    limbs, _ = _carry(limbs + _col(field, limbs, limbs.ndim) * (borrow < 0))
    return limbs.int()


def neg_mod(field: Field, a) -> torch.Tensor:
    return sub_mod(field, torch.zeros_like(a), a)


def mont_mul(field: Field, a, b) -> torch.Tensor:
    """Elementwise Montgomery product a * b * R^-1 mod p (inputs < p).

    Schoolbook into 2L+1 int64 columns (each 16x16 product < 2^32, a
    column < 2^38 throughout), then the Montgomery reduction."""
    L = field.n_limbs
    a, b = a.long(), b.long()
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shape), b.expand(shape)
    t = torch.zeros((2 * L + 1,) + shape[1:], dtype=torch.int64, device=a.device)
    for j in range(L):
        t[j : j + L] += a * b[j]
    return _mont_reduce(field, t)


def _mont_reduce(field: Field, t: torch.Tensor) -> torch.Tensor:
    """(2L+1, *S) int64 columns of a value T < R p -> T R^-1 mod p as
    (L, *S) int32 limbs: L word-serial steps m = t_i * (-p^-1) mod 2^16,
    t += m * p << 16 i, then one conditional subtract (the result is
    < 2p).  t is updated in place."""
    L = field.n_limbs
    p = _col(field, t, t.ndim)
    pinv = field.p_inv_neg & LIMB_MASK  # -p^-1 mod 2^16
    for i in range(L):
        m = ((t[i] & LIMB_MASK) * pinv) & LIMB_MASK
        t[i : i + L] += m * p
        t[i + 1] += t[i] >> _B
    u, _ = _carry(t[L:])
    return _cond_sub_p(field, u[:L], u[L]).int()


def renorm_relaxed(field: Field, x: torch.Tensor) -> torch.Tensor:
    """Raw limb sums -> proper Montgomery limbs (zk_tpu.fields.device.
    renorm_relaxed): x is a non-negative int64 (L, *S) tensor holding, per
    element, limb-wise sums of at most 2^16 Montgomery representatives
    (a scatter-add of a GKR wiring table), so its value T < 2^16 p <= R p.
    One carry pass, one Montgomery reduction (T R^-1) and one product with
    R^2 give T mod p: the Montgomery form of the true sum."""
    L = field.n_limbs
    limbs, carry = _carry(x.long())
    t = torch.zeros((2 * L + 1,) + x.shape[1:], dtype=torch.int64, device=x.device)
    t[:L] = limbs
    t[L] = carry
    canon = _mont_reduce(field, t)
    return mont_mul(field, canon, _bcast_const(field, field.R2, canon))


def _bcast_const(field: Field, value: int, like: torch.Tensor) -> torch.Tensor:
    return cached_const(field, value, False, like.device).reshape(
        (field.n_limbs,) + (1,) * (like.ndim - 1)
    )


def to_mont(field: Field, a) -> torch.Tensor:
    """Canonical limbs -> Montgomery form (multiply by R^2)."""
    return mont_mul(field, a, _bcast_const(field, field.R2, a))


def from_mont(field: Field, a) -> torch.Tensor:
    """Montgomery form -> canonical limbs (multiply by 1)."""
    return mont_mul(field, a, _bcast_const(field, 1, a))


def lerp(field: Field, left, right, r) -> torch.Tensor:
    """left - r * (left - right): the sumcheck fold step
    (evaluation_form.rs:68).  ``r`` broadcasts."""
    return sub_mod(field, left, mont_mul(field, sub_mod(field, left, right), r))


# --------------------------------------------------------------------------
# wide sums
# --------------------------------------------------------------------------

# a column sum of up to 2^40 limbs (< 2^56) carried into 16-bit limbs
# spans at most L+3 limbs
_WIDE_EXTRA = 3


@functools.lru_cache(maxsize=None)
def _wide_weights(field: Field, width: int, mont_out: bool, device: torch.device):
    """(L, width): column j = canonical limbs of 2^(16 j) (times R when
    mont_out) mod p.  mont_mul(limb_j, col_j) = limb_j * 2^(16 j) * R^-1
    (resp. without the R^-1), so the columns position each limb and
    un-scale (or keep) the Montgomery factor in one product."""
    L = field.n_limbs
    out = np.zeros((L, width), dtype=np.int64)
    scale = field.R if mont_out else 1
    for j in range(width):
        out[:, j] = _int_to_limbs((pow(2, _B * j, field.p) * scale) % field.p, L)
    return torch.from_numpy(out).to(device)


def renorm_wide(field: Field, cols: torch.Tensor, mont_out: bool) -> torch.Tensor:
    """Non-negative int64 limb columns (W, *S) with value V = sum_j cols_j
    2^(16 j) (each column < 2^56) -> V mod p as (L, *S) limbs.

    V is a sum of Montgomery representatives, so mont_out=True returns the
    Montgomery form of the true sum and mont_out=False its canonical value
    (V * R^-1 mod p)."""
    L = field.n_limbs
    W = cols.shape[0] + _WIDE_EXTRA
    pad = torch.zeros((_WIDE_EXTRA,) + cols.shape[1:], dtype=torch.int64, device=cols.device)
    limbs, _ = _carry(torch.cat([cols.long(), pad]))  # carry is 0
    rest = cols.shape[1:]
    a = torch.zeros((L, W) + rest, dtype=torch.int64, device=cols.device)
    a[0] = limbs
    w = _wide_weights(field, W, mont_out, cols.device).reshape((L, W) + (1,) * len(rest))
    terms = mont_mul(field, a, w)  # (L, W, *S)
    while terms.shape[1] > 1:
        if terms.shape[1] % 2:
            terms = torch.cat([terms, torch.zeros_like(terms[:, :1])], dim=1)
        h = terms.shape[1] // 2
        terms = add_mod(field, terms[:, :h], terms[:, h:])
    return terms[:, 0]


def sum_mod(field: Field, a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Modular sum along an element axis: exact int64 limb column sums,
    then one renorm (Montgomery in, Montgomery out)."""
    a = torch.movedim(a, axis, -1)
    if a.shape[-1] > (1 << 40):
        raise ValueError("sum_mod supports up to 2^40 summands")
    return renorm_wide(field, a.long().sum(dim=-1), mont_out=True).int()
