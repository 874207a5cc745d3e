"""Hypercube pairing-index utilities (host tier; the port's copy of
``zk_tpu.poly.pairing_index``, pairing_index.rs).  The tensors never
materialize these indices (the fold's pairing is a reshape), but they
state the variable order: variable 0 is the most significant bit of the
element index."""

from __future__ import annotations

from typing import Iterator


def mask(n: int) -> int:
    """n low bits set (pairing_index.rs:24-26)."""
    return (1 << n) - 1


def insert_bit(val: int, index: int, bit: int) -> int:
    """Insert a bit at position ``index`` counted from the LSB
    (pairing_index.rs:16-20)."""
    high = val >> index
    low = val & mask(index)
    return (high << (index + 1)) | (bit << index) | low


def index_pair(n_vars: int, index: int) -> Iterator[tuple[int, int]]:
    """All 2^(n-1) index pairs differing only in variable ``index``
    (pairing_index.rs:2-9): pairs (i0, i0 | 2^(n-1-index)) in ascending
    order of the reduced index."""
    base = n_vars - 1
    for val in range(1 << base):
        low = insert_bit(val, base - index, 0)
        yield (low, low | (1 << (base - index)))
