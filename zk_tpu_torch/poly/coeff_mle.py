"""Sparse coefficient-form multilinear polynomials (host tier).

The port's copy of ``zk_tpu.poly.coeff_mle`` (polynomial/src/multilinear/
coefficient_form.rs).  This representation is the reference's
test-vector generator (it bridges to the dense evaluation form through
the hypercube walk, coefficient_form.rs:340-347) and is never on the
prover's path, so it stays in exact Python ints on the host.

Conventions (coefficient_form.rs:18-26): variable i has id 2^i (LSB =
FIRST variable); a monomial's dict key is the sum of its variables' ids.
E.g. for [a, b, c]: ab -> key 3, bc -> key 6.
"""

from __future__ import annotations

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.poly.hypercube import BooleanHyperCube, binary_string
from zk_tpu_torch.poly.univariate import UnivariatePolynomial


# ----------------------------------------------------------------- selectors


def selector_to_index(selector: list[bool]) -> int:
    """coefficient_form.rs:418-430: first element is id 1, doubling after."""
    total, adder = 0, 1
    for present in selector:
        if present:
            total += adder
        adder *= 2
    return total


def selector_from_usize(value: int, exact_size: int) -> list[bool]:
    """coefficient_form.rs:433-446: LSB-first bool vector, resized."""
    out = [c == "1" for c in format(value, "b")]
    out.reverse()
    out += [False] * (exact_size - len(out))
    return out[:exact_size] if len(out) > exact_size else out


def selector_from_position(size: int, position: int) -> list[bool]:
    """coefficient_form.rs:450-458."""
    if position > size - 1:
        raise ValueError("position index out of bounds")
    sel = [False] * size
    sel[position] = True
    return sel


def bit_count_for_n_elem(size: int) -> int:
    """coefficient_form.rs:517-523: bits needed to index `size` elements."""
    return len(format(size - 1, "b"))


def mapping_instruction_from_variable_presence(presence: list[bool]) -> list[tuple[int, int]]:
    """coefficient_form.rs:469-483."""
    next_var = 0
    mapping = []
    for index, is_present in enumerate(presence):
        if is_present:
            if next_var != index:
                mapping.append((index, next_var))
            next_var += 1
    return mapping


def _to_power_of_two(instructions):
    return [(2**a, 2**b) for a, b in instructions]


class CoeffMultilinearPolynomial:
    """Monomial-indexed sparse multilinear polynomial."""

    def __init__(self, field: Field, n_vars: int, coefficients: dict[int, int]):
        self.field = field
        self.n_vars = n_vars
        self.coefficients = {k: v % field.p for k, v in coefficients.items()}

    # ------------------------------------------------------- constructors

    @classmethod
    def new(cls, field: Field, number_of_variables: int, terms) -> "CoeffMultilinearPolynomial":
        """From (coefficient, selector) terms (coefficient_form.rs:158-175)."""
        coefficients: dict[int, int] = {}
        for coeff, selector in terms:
            if len(selector) != number_of_variables:
                raise ValueError(
                    "the selector array len should be the same as the number of variables"
                )
            key = selector_to_index(selector)
            coefficients[key] = field.add(coefficients.get(key, 0), coeff % field.p)
        return cls(field, number_of_variables, coefficients)

    @classmethod
    def new_with_coefficient(
        cls, field: Field, number_of_variables: int, coefficients: dict[int, int]
    ) -> "CoeffMultilinearPolynomial":
        """coefficient_form.rs:179-193."""
        if coefficients:
            if max(coefficients) >= (1 << number_of_variables):
                raise ValueError(
                    "coefficient map represents more than specificed number of variables"
                )
        return cls(field, number_of_variables, coefficients)

    @classmethod
    def additive_identity(cls, field: Field) -> "CoeffMultilinearPolynomial":
        return cls.new(field, 0, [])

    @classmethod
    def multiplicative_identity(cls, field: Field) -> "CoeffMultilinearPolynomial":
        return cls.new(field, 0, [(1, [])])

    # -------------------------------------------------------- evaluation

    def evaluate_slice(self, assignments: list[int]) -> int:
        """Assign every variable (coefficient_form.rs:39-68)."""
        if self.n_vars == 0:
            return self.coefficients.get(0, 0)
        if len(assignments) < self.n_vars:
            raise ValueError("evaluate requires an assignment for every variable")
        assignments = assignments[: self.n_vars]
        indexed = [
            (selector_from_position(self.n_vars, pos), a)
            for pos, a in enumerate(assignments)
        ]
        evaluated = self.partial_evaluate(indexed)
        return evaluated.coefficients.get(0, 0)

    def partial_evaluate(self, assignments) -> "CoeffMultilinearPolynomial":
        """Fix selected variables (coefficient_form.rs:72-104).

        assignments: list of (selector: list[bool], value: int).  Oversized
        selectors are silently skipped (reference behavior); selectors that
        pick zero or multiple variables raise.
        """
        f = self.field
        coeffs = dict(self.coefficients)
        for selector, value in assignments:
            if len(selector) > self.n_vars:
                continue
            variable_indexes = self.get_variable_indexes(self.n_vars, selector)
            for i in variable_indexes:
                if i in coeffs:
                    old = coeffs.pop(i)
                    result_index = i - selector_to_index(selector)
                    updated = f.mul(old, value % f.p)
                    coeffs[result_index] = f.add(coeffs.get(result_index, 0), updated)
        return CoeffMultilinearPolynomial(f, self.n_vars, coeffs)

    # ----------------------------------------------------------- relabel

    def variable_presence_vector(self) -> list[bool]:
        """coefficient_form.rs:242-253."""
        acc = [False] * self.n_vars
        for key in self.coefficients:
            rep = selector_from_usize(key, self.n_vars)
            acc = [a | b for a, b in zip(acc, rep)]
        return acc

    def relabel(self) -> "CoeffMultilinearPolynomial":
        """Drop unused variables, remapping ids (coefficient_form.rs:107-124)."""
        if self.n_vars == 0:
            return self
        presence = self.variable_presence_vector()
        instructions = mapping_instruction_from_variable_presence(presence)
        poly = _remap_coefficient_keys(self.n_vars, self, instructions)
        new_var_count = sum(presence)
        return CoeffMultilinearPolynomial(self.field, new_var_count, poly.coefficients)

    # ----------------------------------------------------------- algebra

    def scalar_multiply(self, scalar: int) -> "CoeffMultilinearPolynomial":
        f = self.field
        return CoeffMultilinearPolynomial(
            f, self.n_vars, {k: f.mul(v, scalar % f.p) for k, v in self.coefficients.items()}
        )

    def __add__(self, rhs: "CoeffMultilinearPolynomial") -> "CoeffMultilinearPolynomial":
        """coefficient_form.rs:350-373: n_vars taken from the operand with
        strictly more coefficient entries (rhs on ties), then validated."""
        f = self.field
        if len(self.coefficients) > len(rhs.coefficients):
            n_vars, longer, shorter = self.n_vars, dict(self.coefficients), rhs.coefficients
        else:
            n_vars, longer, shorter = rhs.n_vars, dict(rhs.coefficients), self.coefficients
        for index, coeff in shorter.items():
            longer[index] = f.add(longer.get(index, 0), coeff)
        return CoeffMultilinearPolynomial.new_with_coefficient(f, n_vars, longer)

    def __mul__(self, rhs: "CoeffMultilinearPolynomial") -> "CoeffMultilinearPolynomial":
        """Variable-disjoint product (coefficient_form.rs:376-415): rhs's
        variables are appended after self's; n_vars add up."""
        f = self.field
        if self.n_vars == 0:
            return rhs.scalar_multiply(self.coefficients.get(0, 0))
        if rhs.n_vars == 0:
            return self.scalar_multiply(rhs.coefficients.get(0, 0))
        out: dict[int, int] = {}
        for i, a in self.coefficients.items():
            for j, b in rhs.coefficients.items():
                if a % f.p == 0 or b % f.p == 0:
                    continue
                left_vec = selector_from_usize(i, self.n_vars)
                right_vec = selector_from_usize(j, rhs.n_vars)
                key = selector_to_index(left_vec + right_vec)
                out[key] = f.add(out.get(key, 0), f.mul(a, b))
        return CoeffMultilinearPolynomial.new_with_coefficient(
            f, self.n_vars + rhs.n_vars, out
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, CoeffMultilinearPolynomial):
            return NotImplemented
        return (
            self.field.p == other.field.p
            and self.n_vars == other.n_vars
            and self.coefficients == other.coefficients
        )

    def __repr__(self):
        return f"CoeffMLE({self.field.name}, n_vars={self.n_vars}, {self.coefficients})"

    # ---------------------------------------------------- index machinery

    @staticmethod
    def get_variable_indexes(number_of_variables: int, selector: list[bool]) -> list[int]:
        """All dense indexes containing exactly the selected variable
        (coefficient_form.rs:285-327, skip-walk)."""
        if len(selector) != number_of_variables:
            raise ValueError(
                "the selector array len should be the same as the number of variables"
            )
        selector_sum = sum(1 for s in selector if s)
        if selector_sum != 1:
            raise ValueError(
                "only select single variable, cannot get indexes for constant or multiple variables"
            )
        variable_id = selector_to_index(selector)
        indexes = []
        count = 0
        skip = False
        max_index = (1 << number_of_variables) - 1
        for i in range(variable_id, max_index + 1):
            if count == variable_id:
                skip = not skip
                count = 0
            if not skip:
                indexes.append(i)
            count += 1
        return indexes

    # ----------------------------------------------------- interpolation

    @classmethod
    def interpolate(cls, field: Field, values: list[int]) -> "CoeffMultilinearPolynomial":
        """MLE of a value vector over the hypercube (coefficient_form.rs:200-214)."""
        if not values:
            return cls.new(field, 0, [])
        num_vars = bit_count_for_n_elem(len(values))
        result = cls.additive_identity(field)
        for i, value in enumerate(values):
            basis = cls.lagrange_basis_poly(field, i, num_vars).scalar_multiply(value)
            result = result + basis
        return result

    @classmethod
    def lagrange_basis_poly(cls, field: Field, index: int, num_of_vars: int):
        return cls.bit_string_checker(field, binary_string(index, num_of_vars))

    @classmethod
    def bit_string_checker(cls, field: Field, bit_string: str):
        """Indicator polynomial of a bit string (coefficient_form.rs:227-237)."""
        acc = cls.multiplicative_identity(field)
        for char in bit_string:
            acc = acc * (cls.check_one(field) if char == "1" else cls.check_zero(field))
        return acc

    @classmethod
    def check_zero(cls, field: Field):
        """p = 1 - a (coefficient_form.rs:256-263)."""
        return cls.new(field, 1, [(1, [False]), (field.neg(1), [True])])

    @classmethod
    def check_one(cls, field: Field):
        """p = a (coefficient_form.rs:266-269)."""
        return cls.new(field, 1, [(1, [True])])

    # ------------------------------------------------------- conversions

    def to_evaluation_form(self) -> list[int]:
        """Dense hypercube evaluations via pointwise walk
        (coefficient_form.rs:340-347)."""
        return [
            self.evaluate_slice(point) for point in BooleanHyperCube(self.n_vars)
        ]

    def to_univariate(self) -> UnivariatePolynomial:
        """coefficient_form.rs:145-157."""
        if self.n_vars > 1:
            raise ValueError(
                "cannot create univariate poly from multilinear poly with more than 1 variable"
            )
        return UnivariatePolynomial(
            self.field,
            [self.coefficients.get(0, 0), self.coefficients.get(1, 0)],
        )

    def to_bytes(self) -> bytes:
        """n_vars u32 BE + per entry (key u64 BE + coeff BE)
        (coefficient_form.rs:128-139; BTreeMap iterates keys ascending)."""
        out = bytearray(self.n_vars.to_bytes(4, "big"))
        for key in sorted(self.coefficients):
            out += key.to_bytes(8, "big")
            out += self.field.to_bytes_be(self.coefficients[key])
        return bytes(out)


def _remap_coefficient_keys(n_vars, poly, mapping_instructions):
    """coefficient_form.rs:486-507."""
    coeffs = dict(poly.coefficients)
    f = poly.field
    for old_var, new_var in _to_power_of_two(mapping_instructions):
        old_indexes = CoeffMultilinearPolynomial.get_variable_indexes(
            n_vars, selector_from_usize(old_var, n_vars)
        )
        for index in old_indexes:
            if index in coeffs:
                coeff = coeffs.pop(index)
                new_index = index - old_var + new_var
                coeffs[new_index] = f.add(coeffs.get(new_index, 0), coeff)
    return CoeffMultilinearPolynomial(f, n_vars, coeffs)
