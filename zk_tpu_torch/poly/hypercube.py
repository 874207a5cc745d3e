"""Boolean hypercube helpers (host tier; the port's copy of
``zk_tpu.poly.hypercube.binary_string``)."""

from __future__ import annotations


def binary_string(index: int, bit_count: int) -> str:
    """Number -> binary string of the given width, MSB first
    (coefficient_form.rs:461-464)."""
    b = format(index, "b")
    return "0" * max(0, bit_count - len(b)) + b
