"""BLS12-381 Fr arithmetic in plain PyTorch, for the benchmark's reference.

An element is a column of 16 limbs of 16 bits, least significant first, of
its Montgomery representative x R mod p, R = 2^256 (the limbs the benchmark
hands the program).  A table of N elements is an int64 tensor (..., 16, N);
a scalar is a (16, 1) column that broadcasts over N.  Products are
schoolbook into 33 int64 columns and one word-serial Montgomery reduction;
sums are exact int64 limb sums turned into Python ints.  Written from the
field's definition; it shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch

P = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
LIMBS = 16
N_BYTES = 32
R = 1 << (16 * LIMBS)
R_INV = pow(R, -1, P)
MASK = 0xFFFF
PINV16 = (-pow(P, -1, 1 << 16)) % (1 << 16)  # -p^-1 mod 2^16
# pair indices per block of a product: bounds the (33, chunk) temporaries
CHUNK = 1 << 21


def int_limbs(v: int) -> list[int]:
    return [(v >> (16 * i)) & MASK for i in range(LIMBS)]


_P_LIMBS = int_limbs(P)


def _p_col(device) -> torch.Tensor:
    return torch.tensor(_P_LIMBS, dtype=torch.int64, device=device).reshape(LIMBS, 1)


def to_mont(v: int) -> int:
    return v * R % P


def from_mont(v: int) -> int:
    return v * R_INV % P


def column(v_mont: int, device) -> torch.Tensor:
    """A (16, 1) int64 column of the Montgomery representative v_mont."""
    return torch.tensor(int_limbs(v_mont % P), dtype=torch.int64, device=device).reshape(LIMBS, 1)


def columns(vs_mont: list[int], device) -> torch.Tensor:
    """(16, len) int64 columns of Montgomery representatives."""
    arr = np.array([int_limbs(v % P) for v in vs_mont], dtype=np.int64).T.reshape(LIMBS, len(vs_mont))
    return torch.from_numpy(arr).to(device)


def ints(t: torch.Tensor) -> list[int]:
    """(16, N) limbs -> the N integers they spell (no reduction)."""
    arr = t.detach().to("cpu", torch.int64).numpy()
    return [sum(int(arr[i, j]) << (16 * i) for i in range(LIMBS)) for j in range(arr.shape[1])]


def _carry(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Signed int64 limb columns (..., K, N) -> 16-bit limbs and the carry
    out of the top limb (floor division, so negative columns borrow)."""
    out = torch.empty_like(t)
    c = torch.zeros_like(t[..., 0, :])
    for k in range(t.shape[-2]):
        v = t[..., k, :] + c
        out[..., k, :] = v & MASK
        c = v >> 16
    return out, c


def _reduce_once(x: torch.Tensor) -> torch.Tensor:
    """x in [0, 2p) as 16-bit limbs -> x mod p."""
    d, borrow = _carry(x - _p_col(x.device))
    return torch.where((borrow == 0).unsqueeze(-2), d, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, _ = _carry(a + b)  # a + b < 2p < 2^256: no carry out
    return _reduce_once(s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s, _ = _carry(a - b + _p_col(a.device))  # in (0, 2p)
    return _reduce_once(s)


def _mul_block(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(a.shape, b.shape)
    t = torch.zeros(shape[:-2] + (2 * LIMBS + 1, shape[-1]), dtype=torch.int64, device=a.device)
    for i in range(LIMBS):  # every column stays below 2^38
        t[..., i : i + LIMBS, :] += a[..., i : i + 1, :] * b
    p = _p_col(a.device)
    for i in range(LIMBS):
        m = ((t[..., i, :] & MASK) * PINV16) & MASK
        t[..., i : i + LIMBS, :] += m.unsqueeze(-2) * p
        t[..., i + 1, :] += t[..., i, :] >> 16
    u, _ = _carry(t[..., LIMBS:, :])  # a b R^-1 < 2p: the top limb is 0
    return _reduce_once(u[..., :LIMBS, :])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b R^-1 mod p, elementwise with broadcasting,
    in blocks of CHUNK elements along the last axis."""
    n = max(a.shape[-1], b.shape[-1])
    if n <= CHUNK:
        return _mul_block(a, b)
    parts = []
    for s in range(0, n, CHUNK):
        pa = a if a.shape[-1] == 1 else a[..., s : s + CHUNK]
        pb = b if b.shape[-1] == 1 else b[..., s : s + CHUNK]
        parts.append(_mul_block(pa, pb))
    return torch.cat(parts, dim=-1)


def fold(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Fix the most significant index bit (variable 0) of (..., 16, 2^k)
    at r: lo + r (hi - lo)."""
    h = x.shape[-1] // 2
    lo, hi = x[..., :h], x[..., h:]
    return add(lo, mul(r, sub(hi, lo)))


def total(x: torch.Tensor) -> int:
    """The sum over the last axis of a (16, N) table, mod p (Montgomery in,
    Montgomery out)."""
    s = sum(x[..., a : a + CHUNK].to(torch.int64).sum(dim=-1) for a in range(0, x.shape[-1], CHUNK))
    return sum(int(v) << (16 * i) for i, v in enumerate(s.cpu().tolist())) % P


def evaluate(x: torch.Tensor, point: list[int]) -> int:
    """The multilinear extension of a (16, 2^k) table at point (canonical
    ints), variable 0 the index's most significant bit; canonical out."""
    x = x.to(torch.int64)
    for r in point:
        x = fold(x, column(to_mont(r), x.device))
    return from_mont(ints(x)[0])


def lagrange_eval(evals: list[int], x: int) -> int:
    """The polynomial through (t, evals[t]), t = 0..d, at x (canonical ints)."""
    n = len(evals)
    acc = 0
    for i, yi in enumerate(evals):
        num, den = 1, 1
        for j in range(n):
            if j != i:
                num = num * (x - j) % P
                den = den * (i - j) % P
        acc = (acc + yi * num * pow(den, -1, P)) % P
    return acc
