"""The reference package's state (numpy arrays) <-> the port's tensors.

JAX tables are (L, N) or (k, L, N) uint32 arrays of 16-bit limbs; the
port's are int32 tensors with the same limbs.  The device sponge state is
(25,) lane-half arrays, a (136,) byte buffer and a position in both
packages (uint32 there, int64 here).  A circuit crosses as its per-layer
numpy wiring arrays.  Every direction copies values only; tensors land on
the card unless ``device`` names another.
"""

from __future__ import annotations

import numpy as np
import torch

from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.gkr.circuit import Circuit
from zk_tpu_torch.poly.mle import MLE
from zk_tpu_torch.utils.stat import to_host


def limbs_from_numpy(arr, device=None) -> torch.Tensor:
    """uint32 limb array (values < 2^16) -> int32 tensor."""
    a = np.asarray(arr)
    if a.size and int(a.max()) >= 1 << 16:
        raise ValueError("limbs must be < 2^16")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(dev.resolve_device(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array."""
    return to_host(t).numpy().astype(np.uint32)


def mle_from_jax(field: Field, n_vars: int, np_data, device=None) -> MLE:
    """An MLE over the same (L, 2^n) Montgomery limbs as a JAX MLE's data."""
    data = limbs_from_numpy(np_data, device)
    if tuple(data.shape) != (field.n_limbs, 1 << n_vars):
        raise ValueError(f"expected ({field.n_limbs}, {1 << n_vars}) limbs, got {tuple(data.shape)}")
    return MLE(field, n_vars, data)


def transcript_state_from_jax(lo, hi, buf, pos: int, device=None):
    """JAX device-sponge state (uint32 arrays) -> (lo, hi, buf, pos) int64."""
    d = dev.resolve_device(device)
    t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64)).to(d)  # noqa: E731
    return t(lo), t(hi), t(buf), int(pos)


def transcript_state_to_jax(lo, hi, buf, pos: int):
    """Port sponge state -> (lo, hi, buf, pos) uint32 numpy arrays."""
    flat = to_host(torch.cat([lo, hi, buf])).numpy().astype(np.uint32)
    return flat[:25], flat[25:50], flat[50:], int(pos)


def circuit_from_jax(jax_circuit) -> Circuit:
    """The port's Circuit with the same gates: built from the JAX circuit's
    ``wiring(i)`` (left, right, is_add) arrays and ``n_inputs``."""
    layers = [tuple(jax_circuit.wiring(i)[:3]) for i in range(len(jax_circuit.layers))]
    return Circuit.from_arrays(layers, jax_circuit.n_inputs)
