"""Distributed Bailey 4-step NTT: one ``all_to_all`` between two sets of
local transforms.

Counterpart of ``zk_tpu.parallel.ntt``.  The length-n transform is viewed
as an (n1, n2) row-major matrix, input index i = i1 n2 + i2, output index
k = k2 n1 + k1, with n1 = 2^floor(log2(n) / 2): column DFTs of length n1
(root w^n2), the twiddle w^(i2 k1), row DFTs of length n2 (root w^n1).
Rank d of a D-rank mesh holds the columns i2 in [d n2/D, (d+1) n2/D):

  1. its column DFTs, batched along axis -2 of (L, n1, n2/D) through the
     port's NTT recursion (``ntt._rec``: the ``ntt_ladder`` kernel);
  2. the twiddle multiply (the ``mont_mul`` kernel), its own slice of the
     twiddle table;
  3. ONE ``all_to_all_single`` swaps the sharded axis from i2 to k1;
  4. the row DFTs of its k1 slice, batched along axis -2 of (L, n2, n1/D).

The result is this rank's (L, n2, n1/D) slice of the (L, n2, n1) output
sharded on k1, natural DFT values X[k2 n1 + k1] = out[:, k2, k1];
``gather_natural`` assembles the (L, n) natural-order transform.  The
inverse uses w^-1 and scales each set of ladders by its length's inverse,
which compose to n^-1.
"""

from __future__ import annotations

import functools
import importlib

import torch

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.fields.kernels import mont_mul
from zk_tpu_torch.parallel.mesh import MeshGroup

NTT = importlib.import_module("zk_tpu_torch.ntt")  # the package's own `ntt` attribute is the function


def _factors(n: int, D: int) -> tuple[int, int]:
    if n < 2 or n & (n - 1):
        raise ValueError("values must be a power of 2")
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 % D or n2 % D:
        raise ValueError(f"both NTT factors ({n1}, {n2}) must be divisible by mesh size {D}")
    return n1, n2


@functools.lru_cache(maxsize=None)
def _local_twiddles(field: Field, n: int, n1: int, D: int, d: int, inverse: bool, device: torch.device):
    """(L, n1 * n2/D) Montgomery limbs, entry [k1, i2] = w^(k1 (d n2/D + i2))."""
    n2 = n // n1
    omega = NTT._root(field, n, inverse, None)
    k1 = torch.arange(n1, dtype=torch.int64, device=device).reshape(n1, 1)
    i2 = torch.arange(d * (n2 // D), (d + 1) * (n2 // D), dtype=torch.int64, device=device).reshape(1, -1)
    return NTT._powers(field, n, omega, device)[:, ((k1 * i2) % n).reshape(-1)].contiguous()


def ntt_sharded(mesh, field: Field, data: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """This rank's part of the distributed NTT of an (L, n) Montgomery
    limb tensor (the same tensor on every rank): the (L, n2, n1/D) slice of
    the output sharded on k1 (module docstring)."""
    group = MeshGroup(mesh)
    D, d = group.size, group.index
    L, n = data.shape
    n1, n2 = _factors(n, D)
    c1, c2 = n1 // D, n2 // D
    omega = NTT._root(field, n, inverse, None)
    cols = data.reshape(L, n1, n2)[:, :, d * c2 : (d + 1) * c2].contiguous()  # [i1, i2 local]
    y = NTT._rec(field, cols, n1, c2, pow(omega, n2, field.p), inverse)  # [k1, i2 local]
    y = mont_mul(field, y.reshape(L, -1), _local_twiddles(field, n, n1, D, d, inverse, data.device))
    # block j of k1 goes to rank j; block s received holds rank s's i2 slice
    sent = y.reshape(L, D, c1, c2).permute(1, 0, 2, 3)
    got = group.all_to_all(sent.contiguous())  # (D [i2 block], L, k1 local, i2 local)
    rows = got.permute(1, 0, 3, 2).reshape(L, n2, c1).contiguous()  # [i2, k1 local]
    return NTT._rec(field, rows, n2, c1, pow(omega, n1, field.p), inverse)  # [k2, k1 local]


def gather_natural(mesh, field: Field, out: torch.Tensor) -> torch.Tensor:
    """Every rank's (L, n2, n1/D) slice -> the (L, n) natural-order
    transform, on every rank (one ``all_gather``)."""
    parts = MeshGroup(mesh).all_gather(out)  # (D, L, n2, n1/D)
    D, L, n2, c1 = parts.shape
    return parts.permute(1, 2, 0, 3).reshape(L, n2 * D * c1)
