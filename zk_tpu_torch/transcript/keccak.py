"""Pure-Python Keccak-256 (original Keccak padding, NOT SHA3).

The port's copy of ``zk_tpu.transcript.keccak``.  The reference transcript
hashes with ``sha3::Keccak256`` (transcript/src/lib.rs:2,6): multi-rate
padding byte 0x01 (SHA3 uses 0x06), rate 136 bytes, 32-byte digest.  The
C backend (``zk_tpu_torch.transcript.native``) gives the same bytes for
the bulk absorptions.
"""

from __future__ import annotations

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y] for lane A[x, y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK64 = (1 << 64) - 1
_RATE = 136  # bytes, for 256-bit capacity


def _rol(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """One Keccak-f[1600] permutation; lanes indexed as A[x + 5*y]."""
    a = lanes
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi: B[y, 2x+3y] = rol(A[x, y], r[x][y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        # chi
        a = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK64)
            for y in range(5)
            for x in range(5)
        ]
        # iota
        a[0] ^= rc
    return a


class Keccak256:
    """Streaming Keccak-256 matching RustCrypto sha3::Keccak256 semantics."""

    def __init__(self):
        self._lanes = [0] * 25
        self._buf = bytearray()

    def update(self, data: bytes) -> "Keccak256":
        self._buf.extend(data)
        while len(self._buf) >= _RATE:
            self._absorb_block(bytes(self._buf[:_RATE]))
            del self._buf[:_RATE]
        return self

    def _absorb_block(self, block: bytes):
        for i in range(_RATE // 8):
            self._lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        self._lanes = keccak_f1600(self._lanes)

    def digest(self) -> bytes:
        # pad: 0x01 ... 0x80 (multi-rate padding with Keccak domain bits)
        block = bytearray(self._buf)
        block.append(0x01)
        block.extend(b"\x00" * (_RATE - len(block)))
        block[-1] |= 0x80
        lanes = list(self._lanes)
        for i in range(_RATE // 8):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        lanes = keccak_f1600(lanes)
        return b"".join(lanes[i].to_bytes(8, "little") for i in range(4))

    def finalize_reset(self) -> bytes:
        """Digest of everything absorbed so far, then a fresh state
        (sha3's ``finalize_reset``, transcript/src/lib.rs:22)."""
        out = self.digest()
        self._lanes = [0] * 25
        self._buf = bytearray()
        return out

    def export_state(self) -> tuple[list[int], bytes]:
        """(25 lanes, pending buffered bytes), for the device sponge."""
        return list(self._lanes), bytes(self._buf)

    def import_state(self, lanes, buf: bytes) -> None:
        self._lanes = [int(l) & _MASK64 for l in lanes]
        self._buf = bytearray(buf)


def keccak256(data: bytes) -> bytes:
    """The Keccak-256 digest of ``data`` (0x01 padding, not SHA3's 0x06)."""
    return Keccak256().update(data).digest()
