"""Keccak-256 (the original padding 0x01, not SHA3's 0x06) and the
Fiat-Shamir transcript of the upstream crate, in plain Python.

The permutation's code is generated once, unrolled: every step is a
bitwise operation on Python ints, one a lane.

Transcript semantics (transcript/src/lib.rs): ``append`` absorbs bytes; a
challenge is the digest of all absorbed so far, after which the sponge
restarts and absorbs the digest; a field element is the digest read
big-endian, mod p.
"""

from __future__ import annotations

import functools

import numpy as np

RATE = 136  # bytes: 1600-bit state, 512-bit capacity
_M64 = (1 << 64) - 1
_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)


def _rotation(x: int, y: int) -> int:
    """rho's offset of lane (x, y): (t+1)(t+2)/2 mod 64 along its orbit."""
    if (x, y) == (0, 0):
        return 0
    cx, cy = 1, 0
    for t in range(24):
        if (cx, cy) == (x, y):
            return ((t + 1) * (t + 2) // 2) % 64
        cx, cy = cy, (2 * cx + 3 * cy) % 5
    raise ValueError((x, y))


@functools.cache
def permutation():
    """Keccak-f[1600]: a function of the 25 lanes (lane A[x, y] at index
    x + 5 y) returning the new list."""
    consts = {"RC": list(_RC)}

    def rol(src: str, r: int, dst: str) -> str:
        consts[f"H{r}"] = _M64 ^ ((1 << r) - 1)
        consts[f"L{r}"] = (1 << r) - 1
        return f"t = {src}; {dst} = ((t << {r}) & H{r}) | ((t >> {64 - r}) & L{r})"

    ind = "        "
    lines = ["def perm(s):", "    " + ", ".join(f"a{i}" for i in range(25)) + " = s", "    for rc in RC:"]
    for x in range(5):
        lines.append(ind + f"c{x} = a{x} ^ a{x + 5} ^ a{x + 10} ^ a{x + 15} ^ a{x + 20}")
    for x in range(5):  # theta
        lines.append(ind + rol(f"c{(x + 1) % 5}", 1, "t") + f"; d{x} = c{(x - 1) % 5} ^ t")
    for x in range(5):  # rho and pi: B[y, 2x + 3y] = rot(A[x, y])
        for y in range(5):
            r, dst = _rotation(x, y), y + 5 * ((2 * x + 3 * y) % 5)
            src = f"(a{x + 5 * y} ^ d{x})"
            lines.append(ind + (f"b{dst} = {src}" if r == 0 else rol(src, r, f"b{dst}")))
    for y in range(5):  # chi
        for x in range(5):
            lines.append(ind + f"a{x + 5 * y} = b{x + 5 * y} ^ ((~b{(x + 1) % 5 + 5 * y}) & b{(x + 2) % 5 + 5 * y})")
    lines.append(ind + "a0 ^= rc")  # iota
    lines.append("    return [" + ", ".join(f"a{i}" for i in range(25)) + "]")
    exec("\n".join(lines), consts)  # noqa: S102 - code generated above from constants
    return consts["perm"]


class Keccak256:
    """A streaming Keccak-256 sponge."""

    def __init__(self):
        self.lanes = [0] * 25
        self.pending = bytearray()

    def update(self, data: bytes) -> None:
        self.pending += data
        n = len(self.pending) // RATE * RATE
        if n:
            block_lanes = np.frombuffer(bytes(self.pending[:n]), dtype="<u8").reshape(-1, RATE // 8).tolist()
            perm, a = permutation(), self.lanes
            for block in block_lanes:
                for i, v in enumerate(block):
                    a[i] ^= v
                a = perm(a)
            self.lanes = a
            del self.pending[:n]

    def digest(self) -> bytes:
        block = bytearray(self.pending) + b"\x01" + bytes(RATE - len(self.pending) - 1)
        block[-1] |= 0x80
        a = list(self.lanes)
        for i, v in enumerate(np.frombuffer(bytes(block), dtype="<u8").tolist()):
            a[i] ^= v
        a = permutation()(a)
        return b"".join(v.to_bytes(8, "little") for v in a[:4])


class Transcript:
    """The upstream Fiat-Shamir transcript over Keccak-256."""

    def __init__(self):
        self.sponge = Keccak256()

    def append(self, data: bytes) -> None:
        self.sponge.update(data)

    def challenge(self, p: int) -> int:
        digest = self.sponge.digest()
        self.sponge = Keccak256()
        self.sponge.update(digest)
        return int.from_bytes(digest, "big") % p
