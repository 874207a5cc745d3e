"""Elementwise field kernels: Montgomery product and lerp.

Counterpart of ``zk_tpu.fields.pallas_kernels``.  Two wrappers, each of a
hand-written CUDA kernel in csrc/elementwise.cu, with the plain torch
version beside it:

  * ``mont_mul`` (replaces ``mont_mul_pallas``): a * b * R^-1 mod p;
  * ``lerp``     (replaces ``lerp_pallas``): left - r (left - right) at
    one scalar r.

Both take contiguous (L, N) int32 Montgomery limb tensors of one shape,
for any N, on every device.  Where the JAX dispatcher falls back to jnp
(other shapes, mismatched operands), these wrappers raise.  A CPU tensor takes the plain version
(``zk_tpu_torch.fields.device``), a CUDA tensor launches the kernel, any
other device raises.  The CUDA kernels take 4- and 16-limb fields; F17
(one limb) runs on the CPU only.

Also the pieces every kernel wrapper of the port shares: the field
parameter block of csrc/field.cuh, the device checks and the stream.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from zk_tpu_torch import _cuda
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field

CUDA_LIMBS = (4, 16)  # the limb counts csrc/*.cu instantiate (NW = 2, 8)


@functools.lru_cache(maxsize=None)
def field_params(field: Field) -> np.ndarray:
    """csrc/field.cuh FieldParams as uint32 words: p, -p^-1 mod 2^32, and
    the Montgomery forms of the sample points 0..3."""
    nw = field.n_limbs // 2
    words = lambda v: [(v >> (32 * w)) & 0xFFFFFFFF for w in range(nw)]  # noqa: E731
    out = words(field.p) + [(-pow(field.p, -1, 1 << 32)) % (1 << 32)]
    for i in range(4):
        out += words((i * field.R) % field.p)
    return np.array(out, dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def params_ptr(field: Field) -> int:
    """The address of ``field_params(field)`` (its cache keeps the words
    alive), for launches that take it every round."""
    return field_params(field).ctypes.data


def mont_words(field: Field, value: int) -> np.ndarray:
    """The Montgomery form of a host int as NW = L/2 uint32 words."""
    v = value * field.R % field.p
    return np.array([(v >> (32 * w)) & 0xFFFFFFFF for w in range(field.n_limbs // 2)], dtype=np.uint32)


def check_cuda(field: Field, name: str, *tensors: torch.Tensor) -> None:
    """Raise unless the tensors are contiguous, on one CUDA device, of a
    field the kernels take."""
    dev0 = tensors[0].device
    if dev0.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev0}")
    if field.n_limbs not in CUDA_LIMBS:
        raise ValueError(
            f"{name}: no CUDA kernel for {field.name} ({field.n_limbs}-limb elements; "
            f"the kernels take {' or '.join(map(str, CUDA_LIMBS))} limbs)"
        )
    for t in tensors:
        if t.device != dev0:
            raise ValueError(f"{name}: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def cuda_stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(_cuda.stream_ptr(t.device))


def _check_operands(field: Field, name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    L = field.n_limbs
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"{name}: operands must be int32 limbs, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or a.shape[0] != L or b.shape != a.shape:
        raise ValueError(f"{name}: needs two ({L}, N) tensors of one shape, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")


def mont_mul_plain(field: Field, a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    got = dev.mont_mul(field, a, b)
    return got if out is None else out.copy_(got)


def mont_mul(field: Field, a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """Elementwise Montgomery product of two (L, N) limb tensors, into
    ``out`` (an int32 tensor of their shape) if given.  Replaces
    zk_tpu/fields/pallas_kernels.py::mont_mul_pallas."""
    _check_operands(field, "mont_mul", a, b)
    if out is not None:
        _check_operands(field, "mont_mul", a, out)
    if a.device.type == "cpu":
        return mont_mul_plain(field, a, b, out)
    check_cuda(field, "mont_mul", a, b, *(() if out is None else (out,)))
    if out is None:
        out = torch.empty_like(a)
    err = _cuda.lib().zk_mont_mul(
        field.n_limbs, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[1],
        field_params(field).ctypes.data, cuda_stream(a),
    )
    _cuda.check(err, "mont_mul")
    _cuda.count_launch("mont_mul")
    return out


def lerp_plain(field: Field, left: torch.Tensor, right: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return dev.lerp(field, left, right, r.reshape(field.n_limbs, 1))


def lerp(field: Field, left: torch.Tensor, right: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """left - r (left - right) elementwise over two (L, N) limb tensors, r
    one Montgomery scalar of L limbs.  Replaces
    zk_tpu/fields/pallas_kernels.py::lerp_pallas."""
    _check_operands(field, "lerp", left, right)
    if r.dtype != torch.int32 or r.numel() != field.n_limbs:
        raise ValueError(f"lerp: r must be {field.n_limbs} int32 limbs, got {tuple(r.shape)} {r.dtype}")
    if left.device.type == "cpu":
        return lerp_plain(field, left, right, r)
    r = r.reshape(field.n_limbs, 1)
    check_cuda(field, "lerp", left, right, r)
    out = torch.empty_like(left)
    err = _cuda.lib().zk_lerp(
        field.n_limbs, left.data_ptr(), right.data_ptr(), r.data_ptr(), out.data_ptr(),
        left.shape[1], field_params(field).ctypes.data, cuda_stream(left),
    )
    _cuda.check(err, "lerp")
    _cuda.count_launch("lerp")
    return out
