"""Boolean hypercube helpers (host tier; the port's copy of
``zk_tpu.poly.hypercube``): boolean_hypercube.rs:8-45 iterates all 2^n
points as 0/1 assignment vectors in MSB-first binary counting order
(variable 0 is the most significant bit): 000, 001, 010, ..."""

from __future__ import annotations


def binary_string(index: int, bit_count: int) -> str:
    """Number -> binary string of the given width, MSB first
    (coefficient_form.rs:461-464)."""
    b = format(index, "b")
    return "0" * max(0, bit_count - len(b)) + b


class BooleanHyperCube:
    """Iterator over the hypercube's points as lists of 0/1 ints; a
    0-dimensional cube yields nothing (as the reference)."""

    def __init__(self, bit_size: int):
        self.bit_size = bit_size
        self.total_points = 2**bit_size
        self.current_point = 0

    def __iter__(self):
        return self

    def __next__(self) -> list[int]:
        if self.current_point == self.total_points or self.bit_size == 0:
            raise StopIteration
        bits = binary_string(self.current_point, self.bit_size)
        self.current_point += 1
        return [1 if c == "1" else 0 for c in bits]
