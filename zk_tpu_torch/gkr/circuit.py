"""Layered arithmetic circuits for GKR (the port's copy of
``zk_tpu.gkr.circuit``).

A circuit is a list of layers of fan-in-2 add/mul gates; layer 0 is the
output layer, each gate reads two wire indices from the layer below, and
the bottom layer reads the inputs.  Layer value vectors are padded to
powers of two so W_i extends to an MLE with var 0 = MSB (the convention
of the polynomial layer).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zk_tpu_torch.fields.field import Field

ADD = "add"
MUL = "mul"


@dataclass(frozen=True)
class Gate:
    op: str  # "add" | "mul"
    left: int  # wire index in the layer below
    right: int

    def __post_init__(self):
        if self.op not in (ADD, MUL):
            raise ValueError(f"unknown gate op {self.op!r}")


def _k_for(size: int) -> int:
    """Variable count for a layer of `size` wires (>= 1)."""
    return 0 if size <= 1 else (size - 1).bit_length()


class _ArrayLayer:
    """A gate layer backed by numpy wiring arrays instead of Gate objects:
    len/index/iter materialize Gates lazily, so million-gate circuits skip
    per-gate Python construction."""

    __slots__ = ("left", "right", "is_add")

    def __init__(self, left, right, is_add):
        self.left = np.asarray(left, dtype=np.int32)
        self.right = np.asarray(right, dtype=np.int32)
        self.is_add = np.asarray(is_add, dtype=bool)

    def __len__(self) -> int:
        return len(self.left)

    def __getitem__(self, a: int) -> Gate:
        return Gate(ADD if self.is_add[a] else MUL, int(self.left[a]), int(self.right[a]))

    def __iter__(self):
        for a in range(len(self)):
            yield self[a]


class Circuit:
    """Layered fan-in-2 arithmetic circuit.  layers[0] is the output layer;
    gate children index into the next layer down (layers[i+1], or the
    inputs for the last layer)."""

    def __init__(self, layers: list[list[Gate]], n_inputs: int):
        self._init(layers, n_inputs)
        for i, layer in enumerate(layers):
            below = self.layer_size(i + 1)
            for g in layer:
                if not (0 <= g.left < below and 0 <= g.right < below):
                    raise ValueError(f"layer {i} gate references wire outside layer below")

    @classmethod
    def from_arrays(cls, layers: list[tuple], n_inputs: int) -> "Circuit":
        """Build from per-layer (left, right, is_add) numpy wiring arrays,
        validated vectorized (the device prover only touches the arrays)."""
        obj = cls.__new__(cls)
        obj._init([_ArrayLayer(l, r, a) for l, r, a in layers], n_inputs)
        for i, layer in enumerate(obj.layers):
            below = obj.layer_size(i + 1)
            for arr in (layer.left, layer.right):
                if len(arr) and (arr.min() < 0 or arr.max() >= below):
                    raise ValueError(f"layer {i} gate references wire outside layer below")
        return obj

    def _init(self, layers, n_inputs: int) -> None:
        if not layers:
            raise ValueError("circuit must have at least one layer")
        if n_inputs < 1:
            raise ValueError("circuit must have at least one input")
        self.layers = layers
        self.n_inputs = n_inputs
        self._wiring: dict[int, tuple] = {}
        self._dev_cache: dict[tuple, tuple] = {}

    @property
    def depth(self) -> int:
        return len(self.layers)

    def layer_size(self, i: int) -> int:
        """Wire count of level i, where level depth is the input layer."""
        return self.n_inputs if i == self.depth else len(self.layers[i])

    def layer_k(self, i: int) -> int:
        """MLE variable count of level i (padded to a power of two)."""
        return _k_for(self.layer_size(i))

    def wiring(self, i: int) -> tuple:
        """Cached numpy wiring of layer i: (left, right, is_add); gate a's
        output index is its list position a."""
        cached = self._wiring.get(i)
        if cached is None:
            layer = self.layers[i]
            if isinstance(layer, _ArrayLayer):
                cached = (layer.left, layer.right, layer.is_add)
            else:
                cached = (
                    np.array([g.left for g in layer], dtype=np.int32),
                    np.array([g.right for g in layer], dtype=np.int32),
                    np.array([g.op == ADD for g in layer], dtype=bool),
                )
            self._wiring[i] = cached
        return cached

    def device_wiring(self, i: int, device: torch.device) -> tuple:
        """Layer i's wiring on ``device`` as (left, right int64, is_add
        bool) tensors, uploaded once per (layer, device) and cached: the
        prover and verifier index with them every prove."""
        key = (i, torch.device(device))
        cached = self._dev_cache.get(key)
        if cached is None:
            left, right, is_add = self.wiring(i)
            cached = tuple(
                torch.from_numpy(a.astype(t)).to(device)
                for a, t in ((left, np.int64), (right, np.int64), (is_add, bool))
            )
            self._dev_cache[key] = cached
        return cached

    def evaluate(self, field: Field, inputs: list[int]) -> list[list[int]]:
        """Wire values per level, output level first; each vector padded
        with zeros to 2^k.  levels[depth] is the (padded) input vector."""
        if len(inputs) != self.n_inputs:
            raise ValueError("wrong number of inputs")
        levels = [None] * (self.depth + 1)
        cur = [v % field.p for v in inputs]
        levels[self.depth] = cur + [0] * ((1 << _k_for(len(cur))) - len(cur))
        for i in range(self.depth - 1, -1, -1):
            vals = []
            for g in self.layers[i]:
                a, b = cur[g.left], cur[g.right]
                vals.append(field.add(a, b) if g.op == ADD else field.mul(a, b))
            cur = vals
            levels[i] = vals + [0] * ((1 << _k_for(len(vals))) - len(vals))
        return levels

    def outputs(self, field: Field, inputs: list[int]) -> list[int]:
        """The output layer's values (host ints, unpadded)."""
        return self.evaluate(field, inputs)[0][: len(self.layers[0])]
