"""Prime-field specification and exact host-side arithmetic.

The port's own copy of ``zk_tpu.fields.field``.  Host ops take and return
canonical Python ints in [0, p); the torch limb tier
(``zk_tpu_torch.fields.device``) consumes the limb and Montgomery constants
precomputed here, the NTT (``zk_tpu_torch.ntt``) the roots of unity.

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
    """F_p with its limb, Montgomery and FFT constants.  Device tables hold
    ``n_limbs`` base-2^16 limbs in Montgomery form (x * R mod p,
    R = 2^(16 * n_limbs))."""

    name: str
    p: int
    generator: int  # the multiplicative generator of arkworks' config
    bits: int = _dc_field(init=False)
    n_limbs: int = _dc_field(init=False)  # base-2^16 device limbs
    n_bytes: int = _dc_field(init=False)  # canonical BE byte width (64-bit aligned)
    R: int = _dc_field(init=False)  # Montgomery radix 2^(16 * n_limbs)
    R2: int = _dc_field(init=False)  # R^2 mod p
    p_inv_neg: int = _dc_field(init=False)  # -p^-1 mod R
    two_adicity: int = _dc_field(init=False)  # s with p - 1 = 2^s * odd
    two_adic_root: int = _dc_field(init=False)  # generator^((p-1)/2^s) mod p

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
        s = ((p - 1) & -(p - 1)).bit_length() - 1  # trailing zeros of p - 1
        object.__setattr__(self, "two_adicity", s)
        object.__setattr__(self, "two_adic_root", pow(self.generator, (p - 1) >> s, p))

    # ------------------------------------------------------------------ host ops

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError(f"no inverse of 0 in {self.name}")
        return pow(a, -1, self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def from_int(self, a: int) -> int:
        """Canonicalize an arbitrary (possibly negative) int into [0, p)."""
        return a % self.p

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

    # ------------------------------------------------------------- FFT roots

    def get_root_of_unity(self, n: int) -> int:
        """arkworks ``FftField::get_root_of_unity(n)`` for power-of-two n:
        two_adic_root ^ (2^(s - log2 n))  (fft/src/lib.rs:6)."""
        if n <= 0 or n & (n - 1):
            raise ValueError("n must be a power of two")
        log_n = n.bit_length() - 1
        if log_n > self.two_adicity:
            raise ValueError(f"{self.name} has 2-adicity {self.two_adicity}; no 2^{log_n} root")
        return pow(self.two_adic_root, 1 << (self.two_adicity - log_n), self.p)

    # -------------------------------------------------------- limb conversion

    def to_limbs(self, a: int) -> list[int]:
        """Canonical int -> its n_limbs base-2^16 limbs, little-endian."""
        a %= self.p
        return [(a >> (LIMB_BITS * i)) & LIMB_MASK for i in range(self.n_limbs)]

    def from_limbs(self, limbs) -> int:
        """Base-2^16 limbs, little-endian (any int-like values) -> int mod p."""
        return sum(int(limb) << (LIMB_BITS * i) for i, limb in enumerate(limbs)) % self.p

    def to_mont(self, a: int) -> int:
        return (a * self.R) % self.p

    def from_mont(self, a: int) -> int:
        return (a * pow(self.R, -1, self.p)) % self.p

    def __repr__(self):
        return f"Field({self.name}, {self.bits} bits)"

    def __hash__(self):
        # as zk_tpu's Field: the constants' caches key on fields, and a hash
        # of every derived big int would cost each lookup
        return hash((self.name, self.p))
