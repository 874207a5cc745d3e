"""Radix-2 NTT / iNTT over FFT-friendly prime fields.

Counterpart of ``zk_tpu.ntt``.  Black-box spec: fft/src/lib.rs — natural
order in, natural order out, omega = F::get_root_of_unity(n) (arkworks'
generator^((p-1)/2^s) chain); ifft is the same transform with omega^-1
followed by a global n^-1 scale (fft/src/lib.rs:4-19).  The output is the
DFT matrix applied to the input, so every correct split of the transform
gives the same integers.

One route serves both devices: zk_tpu's ``_rec_axis2`` recursion, DFTs
along axis -2 of (L, T, B) limbs with the batch B contiguous.  A
transform of length T <= RADIX is one ``ntt_ladder`` pass (a
decimation-in-time ladder per column); a longer one splits T = t1 * t2
with t1 = RADIX, and one ``ntt_ladder`` pass runs the length-t1 ladders
along axis -2 of (L, t1, t2 * B), multiplies by the twiddles w_T^(k1 i2)
and stores the (L, t2, t1, B) order the recursion on t2 reads: a 2^20
transform is two passes and no copy.  Only the kernel wrapper branches on
the device: a CUDA tensor launches the ``ntt_ladder`` kernel
(csrc/ntt.cu), a CPU tensor takes its plain version, which composes the
row ladder ``ladder_rows_plain``, transposes and ``fields.device.mont_mul``.
The inverse scales each ladder by its own t^-1; the scales compose to T^-1.

Tables (bit reversal, the packed ladder twiddles, the level twiddles) are
built at a transform's first call and cached per (field, length, root,
device): a warm call uploads and rebuilds nothing.  Host conveniences
(``ntt``, ``intt``, ``ntt_with_root``) put their tensors on the card
unless the caller names another device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_tpu_torch import _cuda
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import LIMB_BITS, LIMB_MASK, Field
from zk_tpu_torch.fields.kernels import check_cuda, cuda_stream, field_params, mont_mul, mont_words

LADDER_MAX = 1 << 10  # csrc/ntt.cu MAX_LOG_N: the longest column one kernel pass transforms
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


# shared memory for one tile's elements in csrc/ntt.cu, by limb count: 4
# columns of 1024 at L = 16 (one 512-thread block per SM), 8 at L = 4
TILE_BYTES = {4: 64 << 10, 16: 128 << 10}


def _check_ladder(field: Field, x: torch.Tensor, batch: int | None) -> tuple[int, int]:
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[0] != field.n_limbs:
        raise ValueError(f"ntt_ladder: needs ({field.n_limbs}, n, columns) int32 limbs, got {tuple(x.shape)} {x.dtype}")
    _, n, m = x.shape
    if n < 2 or n & (n - 1) or n > LADDER_MAX:
        raise ValueError(f"ntt_ladder: length {n} is not a power of two in [2, {LADDER_MAX}]")
    if m < 1 or (batch is not None and (batch < 1 or m % batch)):
        raise ValueError(f"ntt_ladder: {m} columns are not a positive multiple of the batch {batch}")
    if not x.is_contiguous():
        raise ValueError("ntt_ladder: limbs must be contiguous")
    return n, m


def ladder_rows_plain(field: Field, x: torch.Tensor, inverse: bool = False, root: int | None = None) -> torch.Tensor:
    """The DIT ladder along the last axis of (L, rows, n) limbs in plain
    torch (zk_tpu.ntt._ladder_body): bit-reversal gather, log2(n) stages of
    contiguous-slice butterflies, then the n^-1 scale when inverse."""
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


def _powers(field: Field, T: int, omega: int, device: torch.device) -> torch.Tensor:
    """(L, T) Montgomery powers omega^0 .. omega^(T-1), by log2(T)
    doublings on the device (one mont_mul each)."""
    L = field.n_limbs
    powers = dev.scalar(field, 1, device=device)
    while powers.shape[1] < T:
        m = powers.shape[1]
        step = dev.scalar(field, pow(omega, m, field.p), device=device).expand(L, m).contiguous()
        powers = torch.cat([powers, mont_mul(field, powers, step)], dim=1)
    return powers


def _level_twiddles(field: Field, T: int, t1: int, omega: int, device: torch.device) -> torch.Tensor:
    """(L, t2 * t1) Montgomery limbs, entry [i2, k1] = omega^(i2 k1) for
    the primitive T-th root omega, T = t1 t2."""
    t2 = T // t1
    i2 = torch.arange(t2, dtype=torch.int64, device=device).reshape(t2, 1)
    k1 = torch.arange(t1, dtype=torch.int64, device=device).reshape(1, t1)
    return _powers(field, T, omega, device)[:, ((i2 * k1) % T).reshape(-1)].contiguous()


_twiddle_table = functools.lru_cache(maxsize=None)(_level_twiddles)  # the plain pass's, cached


def _words(limbs: torch.Tensor) -> torch.Tensor:
    """(L, N) 16-bit limbs -> (N, L/2) 32-bit words (as int32), element-major."""
    w = limbs[0::2].long() | (limbs[1::2].long() << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).int().t().contiguous()


@functools.lru_cache(maxsize=None)
def _kernel_twiddles(field: Field, T: int, t1: int, omega: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """The kernel's level twiddles: (t2 * t1, NW) element-major Montgomery
    words of omega^(i2 k1), times t1^-1 when inverse (the ladder's scale,
    folded into the one product the level does per element).  Only this
    word table stays cached: the limb table it is made from is dropped."""
    tab = _level_twiddles(field, T, t1, omega, device)
    if inverse:
        scale = dev.scalar(field, field.inv(t1), device=device).expand(tab.shape).contiguous()
        tab = mont_mul(field, tab, scale)
    return _words(tab)


def _tile_log_cols(field: Field, t1: int, m: int) -> int:
    """log2 of the columns a block of the kernel owns: TILE_BYTES of
    elements, at most the columns there are (rounded up to a power of 2)."""
    cols = max(1, TILE_BYTES[field.n_limbs] // (t1 * 2 * field.n_limbs))
    cols = min(cols, 1 << (m - 1).bit_length())
    return cols.bit_length() - 1


def _swap(x: torch.Tensor) -> torch.Tensor:
    """Transpose the last two axes into a fresh contiguous tensor (a
    reshape of the transposed view may stay a strided view)."""
    return x.transpose(-1, -2).contiguous()


def ntt_ladder_plain(field: Field, x: torch.Tensor, inverse: bool = False, root: int | None = None,
                     batch: int | None = None) -> torch.Tensor:
    """``ntt_ladder`` in plain torch: the row ladder on the transposed
    columns, the twiddle multiply, and the transposes of the kernel's
    loads and stores."""
    L, t1, m = x.shape
    if batch is None:
        return _swap(ladder_rows_plain(field, _swap(x), inverse, root))
    t2 = m // batch
    omega = _root(field, t1 * t2, inverse, root)
    y = ladder_rows_plain(field, _swap(x), inverse, pow(omega, t2, field.p))  # [(i2, b), k1]
    tw = _twiddle_table(field, t1 * t2, t1, omega, x.device).reshape(L, t2, 1, t1)
    y = dev.mont_mul(field, y.reshape(L, t2, batch, t1), tw)
    return _swap(y)  # [i2, k1, b]


def ntt_ladder(field: Field, x: torch.Tensor, inverse: bool = False, root: int | None = None,
               batch: int | None = None) -> torch.Tensor:
    """One level of the radix recursion on (L, t1, M) Montgomery limbs,
    2 <= t1 <= LADDER_MAX: the length-t1 DFT of every column (axis -2),
    natural order in, times t1^-1 when inverse.  Returns a new tensor.

    ``batch`` None (the last level): the output is (L, t1, M) in natural
    order; ``root`` is the primitive t1-th root (default: the field's,
    inverted when inverse).  ``batch`` B (an upper level, M = t2 B, column
    i2 B + b): the ladders use root^t2, output (k1, i2 B + b) is multiplied
    by root^(k1 i2) and stored at [i2, k1, b] of an (L, t2, t1, B) tensor;
    ``root`` is the primitive (t1 t2)-th root (default as above).
    Replaces zk_tpu/ntt/__init__.py::_ladder_pallas and, on an upper level
    of _rec_axis2, its twiddle multiply and transpose."""
    t1, m = _check_ladder(field, x, batch)
    if x.device.type == "cpu":
        return ntt_ladder_plain(field, x, inverse, root, batch)
    check_cuda(field, "ntt_ladder", x)
    L = field.n_limbs
    if batch is None:
        omega = _root(field, t1, inverse, root)
        tw = _packed_twiddles(field, t1, omega, x.device)
        col_tw, B, out = None, m, torch.empty_like(x)
        scale = mont_words(field, field.inv(t1)) if inverse else None
    else:
        t2 = m // batch
        omega = _root(field, t1 * t2, inverse, root)
        tw = _packed_twiddles(field, t1, pow(omega, t2, field.p), x.device)
        col_tw = _kernel_twiddles(field, t1 * t2, t1, omega, inverse, x.device)
        B, out, scale = batch, x.new_empty((L, t2, t1, batch)), None
    err = _cuda.lib().zk_ntt_ladder(
        L, x.data_ptr(), out.data_ptr(), t1.bit_length() - 1, m, B, _tile_log_cols(field, t1, m),
        tw.data_ptr(), None if col_tw is None else col_tw.data_ptr(),
        None if scale is None else scale.ctypes.data, field_params(field).ctypes.data, cuda_stream(x),
    )
    _cuda.check(err, "ntt_ladder")
    _cuda.count_launch("ntt_ladder")
    return out


def _rec(field: Field, x: torch.Tensor, T: int, B: int, omega: int, inverse: bool) -> torch.Tensor:
    """The DFT along axis -2 of (L, T, B) limbs with the primitive T-th
    root omega (times T^-1 when inverse): zk_tpu.ntt._rec_axis2.  Input
    index i = i1 t2 + i2, output index k = k2 t1 + k1."""
    L = field.n_limbs
    if T <= RADIX:
        return ntt_ladder(field, x.reshape(L, T, B), inverse, root=omega)
    t1, t2 = RADIX, T // RADIX
    y = ntt_ladder(field, x.reshape(L, t1, t2 * B), inverse, root=omega, batch=B)  # [i2, k1, b]
    z = _rec(field, y.reshape(L, t2, t1 * B), t2, t1 * B, pow(omega, t1, field.p), inverse)  # [k2, (k1, b)]
    return z.reshape(L, T, B)


def _transform(field: Field, data: torch.Tensor, omega: int, inverse: bool) -> torch.Tensor:
    L, n = data.shape
    return _rec(field, data.reshape(L, n, 1), n, 1, omega, inverse).reshape(L, n)


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
