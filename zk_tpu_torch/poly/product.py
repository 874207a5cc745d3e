"""Products of same-arity multilinear polynomials (product_poly.rs).

Counterpart of ``zk_tpu.poly.product.ProductPoly``: P(x) = A(x)·B(x)·…
held un-expanded; the prover works on the factor tables.
"""

from __future__ import annotations

from zk_tpu.fields.field import Field
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

    @property
    def max_degree(self) -> int:
        """Per-variable degree bound = number of factors."""
        return len(self.polynomials)
