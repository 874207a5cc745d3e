"""Dense univariate polynomials over a prime field.

Counterpart of ``zk_tpu.poly.univariate`` (polynomial/src/
univariate_poly.rs).  Coefficients are exact Python ints, low degree ->
high degree; the zero polynomial is the empty list
(univariate_poly.rs:83-85).  The verifier's round-poly interpolation and
evaluation are host work on a handful of points.  Products with 256 or
more coefficients go through the NTT on the card (``_mul_ntt``); smaller
ones stay schoolbook in host ints.
"""

from __future__ import annotations

from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.fields.kernels import mont_mul
from zk_tpu_torch.ntt import intt_device, ntt_device


class UnivariatePolynomial:
    def __init__(self, field: Field, coefficients: list[int]):
        self.field = field
        self.coefficients = [c % field.p for c in coefficients]

    # ------------------------------------------------------------- basics

    def is_zero(self) -> bool:
        return len(self.coefficients) == 0

    def degree(self) -> int:
        """univariate_poly.rs:88-94 (the zero polynomial reports 0)."""
        return max(0, len(self.coefficients) - 1)

    def evaluate(self, x: int) -> int:
        """Horner evaluation (univariate_poly.rs:29-40)."""
        acc = 0
        for c in reversed(self.coefficients):
            acc = (acc * x + c) % self.field.p
        return acc

    # ------------------------------------------------------- interpolation

    @classmethod
    def interpolate(cls, field: Field, ys: list[int]) -> "UnivariatePolynomial":
        """Interpolate over the points 0, 1, 2, ... (univariate_poly.rs:43-49),
        as the verifier does for a round polynomial's d+1 evaluations
        (verifier.rs:58): one Lagrange basis polynomial per point, built
        and scaled in place."""
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

    @classmethod
    def interpolate_xy(cls, field: Field, xs, ys) -> "UnivariatePolynomial":
        """Lagrange interpolation via basis-polynomial products
        (univariate_poly.rs:54-80)."""
        result = cls(field, [])
        for i, (x_i, y_i) in enumerate(zip(xs, ys)):
            basis = cls(field, [1])
            for j, x_j in enumerate(xs):
                if j == i:
                    continue
                numerator = cls(field, [field.neg(x_j), 1])  # (x - x_j)
                denom_inv = field.inv(field.sub(x_i, x_j))
                basis = basis * (numerator * cls(field, [denom_inv]))
            result = result + (basis * cls(field, [y_i]))
        return result

    # ------------------------------------------------------------ algebra

    def __add__(self, other: "UnivariatePolynomial") -> "UnivariatePolynomial":
        if self.is_zero():
            return UnivariatePolynomial(self.field, list(other.coefficients))
        if other.is_zero():
            return UnivariatePolynomial(self.field, list(self.coefficients))
        f = self.field
        if len(self.coefficients) >= len(other.coefficients):
            longer, shorter = list(self.coefficients), other.coefficients
        else:
            longer, shorter = list(other.coefficients), self.coefficients
        for i, c in enumerate(shorter):
            longer[i] = f.add(longer[i], c)
        return UnivariatePolynomial(f, longer)

    # products with at least this many coefficients go through the NTT
    _NTT_MUL_MIN = 256

    def __mul__(self, other: "UnivariatePolynomial") -> "UnivariatePolynomial":
        """Polynomial product (univariate_poly.rs:186-209).  The reference
        is schoolbook; the product is fixed by the ring, so large ones go
        through the NTT (evaluate, multiply pointwise, interpolate) when
        the field's 2-adic subgroup holds the padded length."""
        if self.is_zero() or other.is_zero():
            return UnivariatePolynomial(self.field, [])
        out_len = self.degree() + other.degree() + 1
        if out_len >= self._NTT_MUL_MIN:
            n = 1 << (out_len - 1).bit_length()
            if n.bit_length() - 1 <= self.field.two_adicity:
                return self._mul_ntt(other, n, out_len)
        return self._mul_schoolbook(other)

    def _mul_schoolbook(self, other: "UnivariatePolynomial") -> "UnivariatePolynomial":
        f = self.field
        out = [0] * (self.degree() + other.degree() + 1)
        for i, a in enumerate(self.coefficients):
            for j, b in enumerate(other.coefficients):
                out[i + j] = (out[i + j] + a * b) % f.p
        return UnivariatePolynomial(f, out)

    def _mul_ntt(self, other: "UnivariatePolynomial", n: int, out_len: int, device=None) -> "UnivariatePolynomial":
        """The product through length-n transforms (n >= out_len, so no
        wraparound): both inputs zero-padded and transformed, multiplied
        pointwise (the ``mont_mul`` kernel on the card), transformed back.
        On the card unless ``device`` names another."""
        f = self.field
        d = dev.resolve_device(device)
        a = dev.encode_ints(f, self.coefficients + [0] * (n - len(self.coefficients)), device=d)
        b = dev.encode_ints(f, other.coefficients + [0] * (n - len(other.coefficients)), device=d)
        prod = mont_mul(f, ntt_device(f, a), ntt_device(f, b))
        return UnivariatePolynomial(f, dev.decode_ints(f, intt_device(f, prod))[:out_len])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, UnivariatePolynomial)
            and self.field.p == other.field.p
            and self.coefficients == other.coefficients
        )

    def __repr__(self):
        return f"UnivariatePolynomial({self.field.name}, {self.coefficients})"

    # --------------------------------------------------------- identities

    @classmethod
    def additive_identity(cls, field: Field) -> "UnivariatePolynomial":
        return cls(field, [])

    @classmethod
    def multiplicative_identity(cls, field: Field) -> "UnivariatePolynomial":
        return cls(field, [1])

    # ------------------------------------------------------ serialization

    def to_bytes(self) -> bytes:
        """Concat of canonical BE coefficient bytes (univariate_poly.rs:144-150)."""
        return self.field.elements_to_bytes(self.coefficients)

    # ------------------------------------------- Polynomial-trait parity
    # (univariate_poly.rs:102-155)

    def n_vars(self) -> int:
        return 1

    def evaluate_slice(self, assignments: list[int]) -> int:
        """univariate_poly.rs:106-111."""
        if not assignments:
            raise ValueError("empty assignment, cannot evaluate univariate polynomial")
        return self.evaluate(assignments[0])

    def partial_evaluate_selectors(self, assignments) -> "UnivariatePolynomial":
        """Selector-based partial evaluation (univariate_poly.rs:113-135):
        a [True] selector collapses to the constant polynomial, [False]
        is a copy."""
        if len(assignments) != 1:
            raise ValueError("cannot partially evaluate a univariate polynomial at more than 1 variable")
        selector, value = assignments[0]
        if len(selector) != 1:
            raise ValueError("partial evaluation selector should point to only 1 variable")
        if selector[0]:
            return UnivariatePolynomial(self.field, [self.evaluate(value)])
        return UnivariatePolynomial(self.field, list(self.coefficients))

    def relabel(self) -> "UnivariatePolynomial":
        return self

    def to_univariate(self) -> "UnivariatePolynomial":
        return UnivariatePolynomial(self.field, list(self.coefficients))
