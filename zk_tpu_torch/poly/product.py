"""Products, and sums of products, of same-arity multilinear polynomials
(product_poly.rs).

Counterpart of ``zk_tpu.poly.product``: P(x) = A(x)·B(x)·… held
un-expanded, and Σ_t Π_j f_{t,j} (``SumOfProducts``); the prover works on
the factor tables.
"""

from __future__ import annotations

import torch

from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.fields.kernels import mont_mul
from zk_tpu_torch.poly.mle import MLE


class ProductPoly:
    """Product of one or more same-arity MLEs (product_poly.rs:7-10)."""

    def __init__(self, polynomials: list[MLE]):
        if len(polynomials) == 0:
            raise ValueError("cannot create product polynomial from empty polynomials")
        n_vars = polynomials[0].n_vars
        if any(p.n_vars != n_vars for p in polynomials):
            raise ValueError(
                "cannot create product polynomial from polynomial that don't share "
                "the same number of variables"
            )
        self.field: Field = polynomials[0].field
        self.n_vars = n_vars
        self.polynomials = polynomials

    def evaluate(self, assignments: list[int]) -> int:
        """Product of member evaluations (product_poly.rs:36-44)."""
        if len(assignments) != self.n_vars:
            raise ValueError("evaluate must assign to all variables")
        out = 1
        for poly in self.polynomials:
            out = self.field.mul(out, poly.evaluate(assignments))
        return out

    def partial_evaluate(self, initial_var: int, assignments: list[int]) -> "ProductPoly":
        """Member-wise partial evaluation (product_poly.rs:48-63)."""
        return ProductPoly([p.partial_evaluate(initial_var, assignments) for p in self.polynomials])

    def prod_reduce(self) -> torch.Tensor:
        """Elementwise product of the member tables (product_poly.rs:66-74)
        as (L, 2^n) Montgomery limbs on the factors' device (the
        ``mont_mul`` kernel on the card)."""
        result = self.polynomials[0].data
        for poly in self.polynomials[1:]:
            result = mont_mul(self.field, result, poly.data)
        return result

    def prod_reduce_ints(self) -> list[int]:
        return dev.decode_ints(self.field, self.prod_reduce())

    def stacked(self) -> torch.Tensor:
        """Factor tables stacked as (k, L, 2^n)."""
        return torch.stack([p.data for p in self.polynomials])

    @property
    def max_degree(self) -> int:
        """Per-variable degree bound = number of factors."""
        return len(self.polynomials)

    def to_bytes(self) -> bytes:
        """Concat of member to_bytes (product_poly.rs:77-83)."""
        return b"".join(p.to_bytes() for p in self.polynomials)

    def __eq__(self, other) -> bool:
        if not isinstance(other, ProductPoly):
            return NotImplemented
        return (
            self.n_vars == other.n_vars
            and len(self.polynomials) == len(other.polynomials)
            and all(a == b for a, b in zip(self.polynomials, other.polynomials))
        )


class SumOfProducts:
    """Σ_t Π_j f_{t,j}: ProductPoly terms over the same variables (the GKR
    layer polynomial's shape; zk_tpu.poly.product.SumOfProducts).  The
    round polynomial's degree is the largest factor count of a term."""

    def __init__(self, terms: list[ProductPoly]):
        if len(terms) == 0:
            raise ValueError("cannot create sum of products from empty terms")
        n_vars = terms[0].n_vars
        if any(t.n_vars != n_vars for t in terms):
            raise ValueError("sum of products terms must share the same number of variables")
        self.field: Field = terms[0].field
        self.n_vars = n_vars
        self.terms = terms

    def evaluate(self, assignments: list[int]) -> int:
        out = 0
        for t in self.terms:
            out = self.field.add(out, t.evaluate(assignments))
        return out

    def partial_evaluate(self, initial_var: int, assignments: list[int]) -> "SumOfProducts":
        return SumOfProducts([t.partial_evaluate(initial_var, assignments) for t in self.terms])

    def sum_reduce(self) -> torch.Tensor:
        """Sum over the terms of prod_reduce: (L, 2^n) Montgomery limbs."""
        acc = self.terms[0].prod_reduce()
        for t in self.terms[1:]:
            acc = dev.add_mod(self.field, acc, t.prod_reduce())
        return acc

    def to_bytes(self) -> bytes:
        return b"".join(t.to_bytes() for t in self.terms)

    @property
    def max_degree(self) -> int:
        return max(t.max_degree for t in self.terms)


def terms_of(poly) -> list[list]:
    """ProductPoly or SumOfProducts -> per term, its factor tables."""
    if isinstance(poly, SumOfProducts):
        return [[p.data for p in t.polynomials] for t in poly.terms]
    return [[p.data for p in poly.polynomials]]
