"""Prime-field specification and exact host-side arithmetic.

The port's own copy of ``zk_tpu.fields.field`` (less the FFT roots, which
no ported module uses yet).  Host ops take and return canonical Python
ints in [0, p); the torch limb tier (``zk_tpu_torch.fields.device``)
consumes the limb and Montgomery constants precomputed here.

Serialization matches arkworks' ``into_bigint().to_bytes_be()``: the
canonical integer big-endian, zero-padded to the 64-bit-limb-aligned width
of the modulus (evaluation_form.rs:97-103, sumcheck/src/lib.rs:23-29).
Challenge derivation matches ``F::from_be_bytes_mod_order``
(transcript/src/lib.rs:27-30).
"""

from __future__ import annotations

from dataclasses import dataclass, field as _dc_field

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


@dataclass(frozen=True)
class Field:
    """F_p with its limb and Montgomery constants.  Device tables hold
    ``n_limbs`` base-2^16 limbs in Montgomery form (x * R mod p,
    R = 2^(16 * n_limbs))."""

    name: str
    p: int
    bits: int = _dc_field(init=False)
    n_limbs: int = _dc_field(init=False)  # base-2^16 device limbs
    n_bytes: int = _dc_field(init=False)  # canonical BE byte width (64-bit aligned)
    R: int = _dc_field(init=False)  # Montgomery radix 2^(16 * n_limbs)
    R2: int = _dc_field(init=False)  # R^2 mod p
    p_inv_neg: int = _dc_field(init=False)  # -p^-1 mod R

    def __post_init__(self):
        p = self.p
        n_limbs = -(-p.bit_length() // LIMB_BITS)
        R = 1 << (LIMB_BITS * n_limbs)
        object.__setattr__(self, "bits", p.bit_length())
        object.__setattr__(self, "n_limbs", n_limbs)
        # arkworks BigInt<N> with 64-bit limbs; to_bytes_be pads to 8*N bytes
        object.__setattr__(self, "n_bytes", 8 * (-(-p.bit_length() // 64)))
        object.__setattr__(self, "R", R)
        object.__setattr__(self, "R2", (R * R) % p)
        object.__setattr__(self, "p_inv_neg", (-pow(p, -1, R)) % R)

    # ------------------------------------------------------------------ host ops

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError(f"no inverse of 0 in {self.name}")
        return pow(a, -1, self.p)

    # -------------------------------------------------------- serialization

    def to_bytes_be(self, a: int) -> bytes:
        """Canonical big-endian bytes, arkworks ``into_bigint().to_bytes_be()``."""
        return (a % self.p).to_bytes(self.n_bytes, "big")

    def from_be_bytes_mod_order(self, data: bytes) -> int:
        """arkworks ``PrimeField::from_be_bytes_mod_order`` semantics."""
        return int.from_bytes(data, "big") % self.p

    def elements_to_bytes(self, elems) -> bytes:
        """Concat of canonical BE bytes (sumcheck/src/lib.rs:23-29)."""
        return b"".join(self.to_bytes_be(e) for e in elems)

    def __repr__(self):
        return f"Field({self.name}, {self.bits} bits)"
