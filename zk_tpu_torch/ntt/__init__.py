"""Radix-2 NTT / iNTT over FFT-friendly prime fields.

Counterpart of ``zk_tpu.ntt``.  Black-box spec: fft/src/lib.rs — natural
order in, natural order out, omega = F::get_root_of_unity(n) (arkworks'
generator^((p-1)/2^s) chain); ifft is the same transform with omega^-1
followed by a global n^-1 scale (fft/src/lib.rs:4-19).  The output is the
DFT matrix applied to the input, so every correct split of the transform
gives the same integers.

One route serves both devices: the radix recursion of zk_tpu's
``_rec_axis2``, on the last axis.  A transform of length T <= RADIX is one
``ntt_ladder`` (a decimation-in-time ladder per row of the batch); a
longer one splits T = t1 * t2 with t1 = RADIX: ladders of length t1, the
twiddle multiply w_T^(i2 k1) (``fields.kernels.mont_mul``), and the
recursion on t2.  Plain torch transposes between the passes keep the
transformed axis the contiguous last one.  Only the kernel wrappers branch
on the device: a CUDA tensor launches the ``ntt_ladder`` and ``mont_mul``
kernels (csrc/ntt.cu, csrc/elementwise.cu), a CPU tensor takes their
plain versions.  The inverse scales each ladder by its own t^-1; the
scales compose to T^-1.

Tables (bit reversal, the packed ladder twiddles, the twiddle multiply's
tables) are built at a transform's first call and cached per
(field, length, root, device): a warm call uploads and rebuilds nothing.
Host conveniences (``ntt``, ``intt``, ``ntt_with_root``) put their tensors
on the card unless the caller names another device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_tpu_torch import _cuda
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import LIMB_BITS, LIMB_MASK, Field
from zk_tpu_torch.fields.kernels import check_cuda, cuda_stream, field_params, mont_mul, mont_words

LADDER_MAX = 1 << 10  # csrc/ntt.cu MAX_LOG_N: a 1024-element BLS12-381 row is 32 KiB of shared memory
RADIX = LADDER_MAX  # the recursion's split: longer transforms take ladders of RADIX, then recurse


def _bit_reverse_perm(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    perm = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        rev |= ((perm >> b) & 1) << (logn - 1 - b)
    return rev


def _powers_mont(field: Field, base: int, count: int) -> np.ndarray:
    """[base^0, ..., base^(count-1)] as (L, count) int32 Montgomery limbs."""
    out = np.empty((field.n_limbs, count), dtype=np.int32)
    cur = 1
    for j in range(count):
        v = (cur * field.R) % field.p
        for i in range(field.n_limbs):
            out[i, j] = (v >> (LIMB_BITS * i)) & LIMB_MASK
        cur = (cur * base) % field.p
    return out


def _root(field: Field, n: int, inverse: bool, root: int | None) -> int:
    """The transform's primitive n-th root: the caller's, else the field's
    (inverted for the inverse transform)."""
    if root is not None:
        return root % field.p
    omega = field.get_root_of_unity(n)
    return field.inv(omega) if inverse else omega


@functools.lru_cache(maxsize=None)
def _plan(field: Field, n: int, inverse: bool, device: torch.device):
    """(bit-reversal perm, optional n^-1 scale) of the plain ladder, on the
    device; its twiddles are the kernel's packed table."""
    perm = torch.from_numpy(_bit_reverse_perm(n)).to(device)
    scale = dev.scalar(field, field.inv(n), device=device) if inverse else None
    return perm, scale


@functools.lru_cache(maxsize=None)
def _packed_twiddles(field: Field, n: int, omega: int, device: torch.device) -> torch.Tensor:
    """All per-stage twiddle rows packed into one (L, n) table, read by the
    kernel and the plain ladder alike: stage s (span m = 2^s) holds
    w_m^0 .. w_m^(m/2 - 1), w_m = omega^(n/m), at columns [m/2 - 1, m - 1)."""
    packed = np.zeros((field.n_limbs, n), dtype=np.int32)
    for s in range(1, n.bit_length()):
        m = 1 << s
        packed[:, m // 2 - 1 : m - 1] = _powers_mont(field, pow(omega, n // m, field.p), m // 2)
    return torch.from_numpy(packed).to(device)


def _check_ladder(field: Field, x: torch.Tensor) -> int:
    n = x.shape[-1] if x.dim() == 3 else 0
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[0] != field.n_limbs:
        raise ValueError(f"ntt_ladder: needs ({field.n_limbs}, rows, n) int32 limbs, got {tuple(x.shape)} {x.dtype}")
    if n < 2 or n & (n - 1) or n > LADDER_MAX:
        raise ValueError(f"ntt_ladder: length {n} is not a power of two in [2, {LADDER_MAX}]")
    if not x.is_contiguous():
        raise ValueError("ntt_ladder: limbs must be contiguous")
    return n


def ntt_ladder_plain(field: Field, x: torch.Tensor, inverse: bool = False, root: int | None = None) -> torch.Tensor:
    """The ladder in plain torch (zk_tpu.ntt._ladder_body on the last
    axis): bit-reversal gather, log2(n) stages of contiguous-slice
    butterflies, then the n^-1 scale when inverse."""
    L, rows, n = x.shape
    perm, scale = _plan(field, n, inverse, x.device)
    tw = _packed_twiddles(field, n, _root(field, n, inverse, root), x.device)
    x = x.index_select(2, perm)
    for s in range(1, n.bit_length()):
        m = 1 << s
        xb = x.reshape(L, rows, n // m, m)
        e, o = xb[..., : m // 2], xb[..., m // 2 :]
        t = dev.mont_mul(field, o, tw[:, m // 2 - 1 : m - 1].reshape(L, 1, 1, m // 2))
        x = torch.cat([dev.add_mod(field, e, t), dev.sub_mod(field, e, t)], dim=-1).reshape(L, rows, n)
    if scale is not None:
        x = dev.mont_mul(field, x, scale.reshape(L, 1, 1))
    return x


def ntt_ladder(field: Field, x: torch.Tensor, inverse: bool = False, root: int | None = None) -> torch.Tensor:
    """The length-n DFT along the last axis of (L, rows, n) Montgomery
    limbs, 2 <= n <= LADDER_MAX, natural order in and out, times n^-1 when
    inverse.  ``root`` is the primitive n-th root to use (default: the
    field's, inverted when inverse).  Returns a new tensor.  Replaces
    zk_tpu/ntt/__init__.py::_ladder_pallas."""
    n = _check_ladder(field, x)
    if x.device.type == "cpu":
        return ntt_ladder_plain(field, x, inverse, root)
    check_cuda(field, "ntt_ladder", x)
    omega = _root(field, n, inverse, root)
    tw = _packed_twiddles(field, n, omega, x.device)
    scale = mont_words(field, field.inv(n)) if inverse else None
    out = torch.empty_like(x)
    err = _cuda.lib().zk_ntt_ladder(
        field.n_limbs, x.data_ptr(), out.data_ptr(), x.shape[1], n.bit_length() - 1, tw.data_ptr(),
        None if scale is None else scale.ctypes.data, field_params(field).ctypes.data, cuda_stream(x),
    )
    _cuda.check(err, "ntt_ladder")
    _cuda.count_launch("ntt_ladder")
    return out


@functools.lru_cache(maxsize=None)
def _twiddle_table(field: Field, T: int, t1: int, omega: int, batch: int, device: torch.device) -> torch.Tensor:
    """(L, batch * t2 * t1) Montgomery table, entry [b, i2, k1] =
    omega^(i2 k1) for the primitive T-th root omega, T = t1 t2.  Built on
    the device: the powers omega^0 .. omega^(T-1) by log2(T) doublings
    (one mont_mul each), then one gather."""
    L = field.n_limbs
    powers = dev.scalar(field, 1, device=device)
    while powers.shape[1] < T:
        m = powers.shape[1]
        step = dev.scalar(field, pow(omega, m, field.p), device=device).expand(L, m).contiguous()
        powers = torch.cat([powers, mont_mul(field, powers, step)], dim=1)
    t2 = T // t1
    i2 = torch.arange(t2, dtype=torch.int64, device=device).reshape(t2, 1)
    k1 = torch.arange(t1, dtype=torch.int64, device=device).reshape(1, t1)
    table = powers[:, ((i2 * k1) % T).reshape(-1)]  # (L, t2 * t1)
    return table.reshape(L, 1, t2 * t1).expand(L, batch, t2 * t1).reshape(L, -1).contiguous()


def _swap(x: torch.Tensor) -> torch.Tensor:
    """Transpose the last two axes into a fresh contiguous tensor (a
    reshape of the transposed view may stay a strided view)."""
    return x.transpose(-1, -2).contiguous()


def _rec(field: Field, x: torch.Tensor, omega: int, inverse: bool) -> torch.Tensor:
    """The DFT along the last axis of (L, B, T) limbs with the primitive
    T-th root omega (times T^-1 when inverse): zk_tpu.ntt._rec_axis2 with
    the batch in front.  Input index i = i1 t2 + i2, output index
    k = k2 t1 + k1."""
    L, B, T = x.shape
    if T <= RADIX:
        return ntt_ladder(field, x, inverse, root=omega)
    t1, t2 = RADIX, T // RADIX
    p = field.p
    a = _swap(x.reshape(L, B, t1, t2)).reshape(L, B * t2, t1)  # rows (b, i2), axis i1
    y = ntt_ladder(field, a, inverse, root=pow(omega, t2, p))  # [b, i2, k1]
    y = mont_mul(field, y.reshape(L, -1), _twiddle_table(field, T, t1, omega, B, x.device))
    z = _swap(y.reshape(L, B, t2, t1)).reshape(L, B * t1, t2)  # rows (b, k1), axis i2
    z = _rec(field, z, pow(omega, t1, p), inverse)  # [b, k1, k2]
    return _swap(z.reshape(L, B, t1, t2)).reshape(L, B, T)  # [b, k2, k1] = X[k2 t1 + k1]


def _transform(field: Field, data: torch.Tensor, omega: int, inverse: bool) -> torch.Tensor:
    L, n = data.shape
    return _rec(field, data.reshape(L, 1, n), omega, inverse).reshape(L, n)


def _check_length(n: int) -> None:
    if n < 1 or n & (n - 1):
        raise ValueError("values must be a power of 2")


def _transform_device(field: Field, data: torch.Tensor, inverse: bool) -> torch.Tensor:
    if data.dim() != 2 or data.shape[0] != field.n_limbs:
        raise ValueError(f"expected ({field.n_limbs}, n) limbs, got {tuple(data.shape)}")
    n = data.shape[1]
    _check_length(n)
    if n == 1:
        return data
    return _transform(field, data, _root(field, n, inverse, None), inverse)


def ntt_device(field: Field, data: torch.Tensor) -> torch.Tensor:
    """Forward NTT of an (L, n) Montgomery limb tensor, on its device."""
    return _transform_device(field, data, inverse=False)


def intt_device(field: Field, data: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of an (L, n) Montgomery limb tensor (fft/src/lib.rs:11-19)."""
    return _transform_device(field, data, inverse=True)


def ntt(field: Field, coefficients: list[int], device=None) -> list[int]:
    """Host-convenience forward NTT (fft/src/lib.rs:4-8 ``fft``)."""
    if len(coefficients) == 1:
        return [c % field.p for c in coefficients]
    data = dev.encode_ints(field, coefficients, device=dev.resolve_device(device))
    return dev.decode_ints(field, ntt_device(field, data))


def intt(field: Field, evaluations: list[int], device=None) -> list[int]:
    """Host-convenience inverse NTT (fft/src/lib.rs:11-19 ``ifft``)."""
    if len(evaluations) == 1:
        return [c % field.p for c in evaluations]
    data = dev.encode_ints(field, evaluations, device=dev.resolve_device(device))
    return dev.decode_ints(field, intt_device(field, data))


# reference-parity aliases (fft/src/lib.rs naming)
fft = ntt
ifft = intt


def ntt_with_root(field: Field, values: list[int], omega: int, device=None) -> list[int]:
    """``fft_internal`` parity (fft/src/lib.rs:21-46): the DFT with a
    caller-supplied primitive n-th root of unity, no scale."""
    n = len(values)
    if n == 1:
        return [v % field.p for v in values]
    _check_length(n)
    if pow(omega, n, field.p) != 1 or pow(omega, n // 2, field.p) == 1:
        raise ValueError("omega must be a primitive n-th root of unity")
    data = dev.encode_ints(field, values, device=dev.resolve_device(device))
    return dev.decode_ints(field, _transform(field, data, omega % field.p, inverse=False))


def host_dft(field: Field, values: list[int], inverse: bool = False) -> list[int]:
    """O(n^2) reference DFT in exact host ints: the differential oracle
    (the DFT definition that fft_internal's output matches)."""
    n = len(values)
    omega = field.get_root_of_unity(n)
    if inverse:
        omega = field.inv(omega)
    out = []
    for i in range(n):
        acc = 0
        for j, v in enumerate(values):
            acc = (acc + v * pow(omega, i * j, field.p)) % field.p
        out.append(acc)
    if inverse:
        n_inv = field.inv(n)
        out = [(v * n_inv) % field.p for v in out]
    return out
