"""Dense evaluation-form multilinear polynomials on torch tensors.

Counterpart of ``zk_tpu.poly.mle`` (evaluation_form.rs).  The table of all
2^n hypercube evaluations is an (L, 2^n) int32 Montgomery limb tensor.
Variable 0 is the most significant bit of the element index, so folding
variable v is a reshape to (L, 2^v, 2, 2^(n-v-1)) and a lerp across the
middle axis.  Folds starting at variable 0 (evaluate, and the prover's
oracle check) go through the ``fold_multi`` kernel, up to 4 variables per
pass over the table.
"""

from __future__ import annotations

import torch

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.utils.stat import span, to_host


def fold_ladder(field: Field, n_vars: int, initial_var: int, data, rs):
    """Fold len(rs) consecutive variables from initial_var with the
    reshape-and-lerp ladder (zk_tpu/poly/mle.py::_fold_kernel).  data:
    (L, 2^n_vars); rs: (k, L) Montgomery scalars."""
    L = field.n_limbs
    x, n = data, n_vars
    for i in range(rs.shape[0]):
        a, b = 1 << initial_var, 1 << (n - initial_var - 1)
        xr = x.reshape(L, a, 2, b)
        x = dev.lerp(field, xr[:, :, 0, :], xr[:, :, 1, :], rs[i][:, None, None]).reshape(L, a * b)
        n -= 1
    return x


def fold_var0(field: Field, data, rs):
    """Fold the first k variables of an (L, 2^n) table at the (L, k) int32
    Montgomery scalars ``rs`` (on the table's device, so nothing is
    uploaded): a chain of fold_multi passes, up to 4 variables each.  The
    first pass writes a fresh buffer, so ``data`` is left as it was.
    Returns the (L, 2^(n-k)) folded table."""
    from zk_tpu_torch.sumcheck import capacity as C

    L, k = field.n_limbs, rs.shape[1]
    stack = data.reshape(1, L, -1)
    size, i = stack.shape[-1], 0
    out = None
    while i < k:
        f = min(4, k - i)
        if out is None:
            out = stack.new_empty((1, L, size >> f))
        C.fold_multi(field, stack if i == 0 else out, size, rs[:, i : i + f].contiguous(), out=out)
        size >>= f
        i += f
    return out[0, :, :size]


class MLE:
    """MultiLinearPolynomial in dense evaluation form."""

    def __init__(self, field: Field, n_vars: int, data: torch.Tensor):
        """data: (L, 2^n_vars) int32 Montgomery limbs; ``new`` and
        ``random`` build one with validation."""
        self.field = field
        self.n_vars = n_vars
        self.data = data

    @classmethod
    def new(cls, field: Field, n_vars: int, evaluations: list[int], device=None) -> "MLE":
        """Validates len == 2^n_vars (evaluation_form.rs:15-27).  On the
        card unless ``device`` names another."""
        if len(evaluations) != (1 << n_vars):
            raise ValueError("evaluation vec len should equal 2^n_vars")
        return cls(field, n_vars, dev.encode_ints(field, evaluations, device=dev.resolve_device(device)))

    @classmethod
    def random(cls, field: Field, n_vars: int, generator: torch.Generator, device=None) -> "MLE":
        """Random 16-bit limbs with the top limb masked below p's top limb,
        so every element is < p (a valid Montgomery representative).  On
        the card unless ``device`` names another."""
        L = field.n_limbs
        data = torch.randint(
            0, 1 << 16, (L, 1 << n_vars), generator=generator, device=dev.resolve_device(device),
            dtype=torch.int32,
        )
        top = (field.p >> (16 * (L - 1))).bit_length() - 1
        data[L - 1] &= (1 << top) - 1
        return cls(field, n_vars, data)

    @classmethod
    def from_coeff(cls, coeff_poly, device=None) -> "MLE":
        """From a CoeffMultilinearPolynomial through the hypercube walk
        (host ints); on the card unless ``device`` names another."""
        return cls.new(coeff_poly.field, coeff_poly.n_vars, coeff_poly.to_evaluation_form(), device=device)

    def partial_evaluate(self, initial_var: int, assignments: list[int]) -> "MLE":
        """Fix len(assignments) consecutive variables starting at
        initial_var (evaluation_form.rs:40-80)."""
        k = len(assignments)
        if k == 0:
            return MLE(self.field, self.n_vars, self.data)
        if k > self.n_vars or initial_var + k > self.n_vars:
            raise ValueError("partial evaluation out of range")
        rs = dev.encode_ints(self.field, assignments, device=self.data.device)  # (L, k)
        if initial_var == 0:
            return MLE(self.field, self.n_vars - k, fold_var0(self.field, self.data, rs))
        out = fold_ladder(self.field, self.n_vars, initial_var, self.data, rs.t())
        return MLE(self.field, self.n_vars - k, out)

    def evaluate(self, assignments: list[int]) -> int:
        """Full evaluation (evaluation_form.rs:83-89)."""
        if len(assignments) != self.n_vars:
            raise ValueError("evaluate must assign to all variables")
        with span("zk.mle.evaluate"):
            return dev.decode_ints(self.field, self.partial_evaluate(0, assignments).data)[0]

    def evaluation_ints(self) -> list[int]:
        """Canonical evaluations as Python ints."""
        return dev.decode_ints(self.field, self.data)

    def to_bytes(self) -> bytes:
        """Concat of canonical BE bytes (evaluation_form.rs:97-103)."""
        return dev.decode_bytes_be(self.field, self.data)

    def __eq__(self, other) -> bool:
        """Same field, same n_vars, equal limbs (the tables' values; both
        are canonical Montgomery representatives)."""
        if not isinstance(other, MLE):
            return NotImplemented
        a, b = self.data, other.data
        if a.device != b.device:  # compare on the host
            a, b = to_host(a), to_host(b)
        return (
            self.field.p == other.field.p
            and self.n_vars == other.n_vars
            and a.shape == b.shape
            and bool(to_host(torch.eq(a, b).all()))
        )

    def __repr__(self):
        return f"MLE({self.field.name}, n_vars={self.n_vars})"
