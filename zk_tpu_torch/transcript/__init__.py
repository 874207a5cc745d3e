"""Fiat-Shamir transcript, byte-exact with the reference (the port's copy of
``zk_tpu.transcript``).

Semantics (transcript/src/lib.rs:5-34): a running Keccak-256 hasher;
``append`` absorbs bytes; a challenge is the 32-byte digest of everything
absorbed so far, after which the hasher is reset and the digest itself is
re-absorbed (so successive challenges chain).  Challenge -> field element
by big-endian reduction mod p (``from_be_bytes_mod_order``).

The host hasher is the C one (``native``, built at first use) where a C
compiler exists, the pure-Python one (``keccak``) otherwise;
``HAS_NATIVE`` says which (reading it builds the C hasher).  The
device-resident sponge is ``zk_tpu_torch.transcript.device``.
"""

from __future__ import annotations

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.transcript import native
from zk_tpu_torch.transcript.keccak import Keccak256


def __getattr__(name: str):
    if name == "HAS_NATIVE":
        return native.load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Transcript:
    """Running-hash Fiat-Shamir transcript (transcript/src/lib.rs:5-34)."""

    def __init__(self):
        lib = native.load()
        self._hasher = native.NativeKeccak256(lib) if lib is not None else Keccak256()

    def append(self, data: bytes) -> None:
        self._hasher.update(data)

    def sample_challenge(self) -> bytes:
        """32-byte challenge: finalize_reset, then re-absorb the digest
        (transcript/src/lib.rs:20-25)."""
        digest = self._hasher.finalize_reset()
        self._hasher.update(digest)
        return digest

    def sample_field_element(self, field: Field) -> int:
        return field.from_be_bytes_mod_order(self.sample_challenge())

    def sample_n_field_elements(self, field: Field, n: int) -> list[int]:
        return [self.sample_field_element(field) for _ in range(n)]

    def export_state(self) -> tuple[list[int], bytes]:
        """(25 sponge lanes, pending bytes), for the device sponge."""
        return self._hasher.export_state()

    def import_state(self, lanes, buf: bytes) -> None:
        """Resume from a state exported by the device sponge."""
        self._hasher.import_state(lanes, buf)
