"""Host-int univariate interpolation and evaluation for the verifier.

The subset of ``zk_tpu.poly.univariate`` (univariate_poly.rs) that the
sumcheck verifier uses: Lagrange interpolation over 0..d of a round
polynomial's d+1 evaluations (verifier.rs:58) and Horner evaluation, in
exact Python ints with schoolbook products (d is tiny).
"""

from __future__ import annotations

from zk_tpu_torch.fields.field import Field


class UnivariatePolynomial:
    """Coefficients low -> high degree; the zero polynomial is []."""

    def __init__(self, field: Field, coefficients: list[int]):
        self.field = field
        self.coefficients = [c % field.p for c in coefficients]

    def evaluate(self, x: int) -> int:
        """Horner evaluation (univariate_poly.rs:29-40)."""
        acc = 0
        for c in reversed(self.coefficients):
            acc = (acc * x + c) % self.field.p
        return acc

    @classmethod
    def interpolate(cls, field: Field, ys: list[int]) -> "UnivariatePolynomial":
        """Interpolate over the points 0, 1, 2, ... (univariate_poly.rs:43-80)."""
        p = field.p
        xs = list(range(len(ys)))
        result = [0] * len(ys)
        for i, (x_i, y_i) in enumerate(zip(xs, ys)):
            basis = [1]
            denom = 1
            for j, x_j in enumerate(xs):
                if j == i:
                    continue
                # basis *= (x - x_j)
                nxt = [0] * (len(basis) + 1)
                for k, c in enumerate(basis):
                    nxt[k] = (nxt[k] - x_j * c) % p
                    nxt[k + 1] = (nxt[k + 1] + c) % p
                basis = nxt
                denom = (denom * (x_i - x_j)) % p
            scale = (y_i * field.inv(denom)) % p
            for k, c in enumerate(basis):
                result[k] = (result[k] + c * scale) % p
        return cls(field, result)
