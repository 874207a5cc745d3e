"""GKR over a layered add/mul circuit (Thaler, Proofs, Arguments and
Zero-Knowledge, section 4.6, with Libra's two-phase linear-time tables)
and its proof's bytes, in plain PyTorch, for the benchmark's reference.

A circuit's layer i holds fan-in-2 gates; gate a reads wires left[a] and
right[a] of level i + 1 (the inputs below the last layer).  W_i is level
i's wire values, zero-padded to 2^k_i, as a multilinear extension whose
variable 0 is the index's most significant bit.  Tables are (16, N) int64
Montgomery limbs (``field``).  Per layer, with the claim m = W~_i(r):

  phase 1 (k_in rounds over b):  G1(b) W(b) + A2(b), where
      G1(b) = sum over gates with left = b of eq(r, a) for an add gate,
              eq(r, a) W(right) for a mul gate,
      A2(b) = sum over add gates with left = b of eq(r, a) W(right);
  phase 2 (k_in rounds over c, b fixed at the phase-1 challenges u):
      add_u(c) (W(u) + W(c)) + mul_u(c) W(u) W(c), where add_u (mul_u)
      sums eq(r, a) eq(u, left) over the add (mul) gates with right = c;
  the line q(t) = W~(u + t (v - u)) through the two claims, sent as its
  values at t = 0..k_in; r* from the transcript; the next claim is q(r*)
  at r = u + r* (v - u).  Every round sends the round polynomial's values
  at t = 0, 1, 2 (degree 2 in each variable).

Fiat-Shamir order: the output bytes, r (k_0 challenges), then per layer
the claim m, each round's values and its challenge, [w_b, w_c] = [q(0),
q(1)], q's values, r*.  The proof's bytes: u32 output count, the output
bytes, u32 layer count, then per layer u32 length + the sumcheck proof
(``sumcheck.proof_bytes`` of m and the 2 k_in round polynomials), w_b,
w_c, u32 count + q's values; every value canonical, 32 bytes big-endian.

Written from the protocol; it shares no code with the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import field as F
from benchmark.reference import sumcheck as RS
from benchmark.reference.keccak import Transcript

_ONE = 1  # the integer 1 as limbs: a Montgomery product with it leaves x R^-1, the canonical value
_R2 = F.R * F.R % F.P  # a Montgomery product with it turns a canonical value into its representative
_SHIFT16 = F.to_mont(1 << 16)
MAX_FAN = 1 << 16  # the exact scatter's limit on the gates that share a wire


class Circuit:
    """Layers output first, each (left, right, is_add) tensors of one
    length, over ``n_inputs`` inputs."""

    def __init__(self, layers: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], n_inputs: int):
        self.layers = layers
        self.n_inputs = n_inputs

    @property
    def depth(self) -> int:
        return len(self.layers)

    def size(self, i: int) -> int:
        return self.n_inputs if i == self.depth else len(self.layers[i][0])

    def k(self, i: int) -> int:
        return (self.size(i) - 1).bit_length()

    def to(self, device) -> Circuit:
        return Circuit([tuple(t.to(device) for t in layer) for layer in self.layers], self.n_inputs)


def matmul(n: int, device="cpu") -> Circuit:
    """C = A B for n x n matrices (n a power of two): A row-major at wires
    [0, n^2), B row-major at [n^2, 2 n^2); one layer of n^3 products, gate
    (i, j, k) at i n^2 + j n + k reading A[i, k] and B[k, j]; then log2 n
    layers of sums of adjacent wire pairs, so output i n + j is C[i, j]."""
    g = torch.arange(n**3, dtype=torch.int64, device=device)
    i, j, k = g // (n * n), g // n % n, g % n
    layers = [(i * n + k, n * n + k * n + j, torch.zeros(n**3, dtype=torch.bool, device=device))]
    size = n**3 // 2
    while size >= n * n:
        a = torch.arange(size, dtype=torch.int64, device=device)
        layers.append((2 * a, 2 * a + 1, torch.ones(size, dtype=torch.bool, device=device)))
        size //= 2
    return Circuit(layers[::-1], 2 * n * n)


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------


def _col(v: int, device) -> torch.Tensor:
    return F.column(F.to_mont(v), device)


def to_bytes(x: torch.Tensor) -> bytes:
    """(16, N) Montgomery limbs -> the N canonical values, 32 bytes each,
    big-endian."""
    canon = F.mul(x.to(torch.int64), F.column(_ONE, x.device))
    return canon.cpu().numpy().T[:, ::-1].astype(">u2").tobytes()


def from_bytes(data: bytes, device) -> torch.Tensor:
    """Big-endian 32-byte values (any below 2^256, taken mod p) -> (16, N)
    Montgomery limbs."""
    limbs = np.ascontiguousarray(np.frombuffer(data, dtype=">u2").reshape(-1, F.LIMBS)[:, ::-1].T, dtype=np.int64)
    return F.mul(torch.from_numpy(limbs).to(device), F.column(_R2, device))


def eq_table(point: list[int], device) -> torch.Tensor:
    """eq(point, b) = prod_j (p_j b_j + (1 - p_j)(1 - b_j)) for every b of
    the hypercube, b_0 the index's most significant bit: the last
    variable first, each step putting the next one above the index."""
    x = _col(1, device)
    for p in reversed(point):
        xp = F.mul(x, _col(p, device))
        x = torch.cat([F.sub(x, xp), xp], dim=-1)
    return x


def scatter(size: int, pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[b] = the sum of vals[a] over the a with pos[a] = b, exact: raw
    int64 limb sums, each below MAX_FAN 2^16, split as L + 2^16 H with L
    and H below 2^256, each brought below p by two conditional
    subtractions, then L + H 2^16 mod p."""
    if len(pos) and int(torch.bincount(pos).max()) >= MAX_FAN:
        raise ValueError("a wire feeds too many gates for the exact scatter")
    acc = torch.zeros((F.LIMBS, size), dtype=torch.int64, device=vals.device)
    acc.index_add_(1, pos, vals)
    lo, hi = (F._reduce_once(F._reduce_once(t)) for t in (acc & F.MASK, acc >> 16))
    return F.add(lo, F.mul(hi, F.column(_SHIFT16, vals.device)))


def evaluate(circuit: Circuit, inputs: torch.Tensor) -> list[torch.Tensor]:
    """Every level's wire values, output level first, zero-padded to 2^k."""
    d = circuit.depth
    cur = torch.nn.functional.pad(inputs.to(torch.int64), (0, (1 << circuit.k(d)) - circuit.n_inputs))
    levels = [cur]
    for i in range(d - 1, -1, -1):
        left, right, is_add = circuit.layers[i]
        lv, rv = cur[:, left], cur[:, right]
        if bool(is_add.all()):
            cur = F.add(lv, rv)
        elif not bool(is_add.any()):
            cur = F.mul(lv, rv)
        else:
            cur = torch.where(is_add, F.add(lv, rv), F.mul(lv, rv))
        del lv, rv
        cur = torch.nn.functional.pad(cur, (0, (1 << circuit.k(i)) - cur.shape[-1]))
        levels.append(cur)
    return levels[::-1]


def line(w: torch.Tensor, u: list[int], v: list[int]) -> list[int]:
    """q(t) = W~(u + t (v - u)) at t = 0..k: W is folded variable by
    variable at u_j + t d_j, d = v - u, keeping each entry as its
    coefficients in t, a (degree + 1, 16, N) stack (row e: t^e)."""
    x = w.unsqueeze(0)
    for uj, vj in zip(u, v):
        h = x.shape[-1] // 2
        diff = F.sub(x[..., h:], x[..., :h])
        at_u = F.add(x[..., :h], F.mul(diff, _col(uj, w.device)))  # lo + u_j (hi - lo)
        step = F.mul(diff, _col((vj - uj) % F.P, w.device))  # t d_j (hi - lo), a degree up
        zero = torch.zeros_like(step[:1])
        x = F.add(torch.cat([at_u, zero]), torch.cat([zero, step]))
    cs = [F.from_mont(c) for c in F.ints(x[:, :, 0].t())]
    return [sum(c * pow(t, e, F.P) for e, c in enumerate(cs)) % F.P for t in range(len(u) + 1)]


# --------------------------------------------------------------------------
# prover
# --------------------------------------------------------------------------


def absorbed(out_bytes: bytes) -> Transcript:
    """A fresh transcript that has absorbed the output bytes."""
    t = Transcript()
    t.append(out_bytes)
    return t


def _challenge(t: Transcript, bits: int | None) -> int:
    r = t.challenge(F.P)
    return r if bits is None else r & ((1 << bits) - 1)


def _elements(vals: list[int]) -> bytes:
    return b"".join(v.to_bytes(F.N_BYTES, "big") for v in vals)


def _sums(x: torch.Tensor, terms: list[list[int]]) -> list[int]:
    """The round polynomial's values at t = 0, 1, 2 (canonical): the sum
    over the pairs (lo, hi) of each term's product of its tables x[f] at
    lo + t (hi - lo), x a (tables, 16, 2^k) stack, in blocks of pairs."""
    h = x.shape[-1] // 2
    sums = [0, 0, 0]
    for s in range(0, h, F.CHUNK):
        e = min(h, s + F.CHUNK)
        lo, hi = x[..., s:e], x[..., h + s : h + e]
        at = torch.stack([lo, hi, F.add(hi, F.sub(hi, lo))])  # every table at t = 0, 1, 2
        for term in terms:
            prod = at[:, term[0]]
            for f in term[1:]:
                prod = F.mul(prod, at[:, f])
            sums = [(a + F.total(p)) % F.P for a, p in zip(sums, prod)]
    return [F.from_mont(v) for v in sums]


def _rounds(t: Transcript, x: torch.Tensor, terms: list[list[int]], bits: int | None):
    """The rounds of one phase over the sum of the terms' products of the
    stacked tables x: per round the values at t = 0, 1, 2, absorbed, then
    the challenge, at which every table is folded.  Returns the round
    polynomials, the challenges and the tables as folded to one entry."""
    rps, chs = [], []
    while x.shape[-1] > 1:
        values = _sums(x, terms)
        t.append(_elements(values))
        r = _challenge(t, bits)
        rps.append(values)
        chs.append(r)
        x = F.fold(x, _col(r, x.device))
    return rps, chs, x


def prove(circuit: Circuit, inputs: torch.Tensor, start=absorbed, bits: int | None = None) -> tuple[bytes, bytes]:
    """The proof's bytes and the output bytes for ``inputs`` (16,
    n_inputs) Montgomery limbs.  ``start`` makes the transcript that has
    absorbed the output bytes; ``bits`` keeps only the low bits of every
    challenge (the control's broken guarantee)."""
    levels = evaluate(circuit, inputs)
    dev = inputs.device
    n_out = circuit.size(0)
    out_bytes = to_bytes(levels[0][:, :n_out])
    t = start(out_bytes)
    r = [_challenge(t, bits) for _ in range(circuit.k(0))]
    m = F.evaluate(levels[0], r)
    proof = bytearray(n_out.to_bytes(4, "big") + out_bytes + circuit.depth.to_bytes(4, "big"))
    for i in range(circuit.depth):
        left, right, is_add = circuit.layers[i]
        w = levels[i + 1]
        size = w.shape[-1]
        eq_r = eq_table(r, dev)[:, : len(left)]
        zero = torch.zeros_like(eq_r)

        wr = F.mul(eq_r, w[:, right])
        g1 = scatter(size, left, torch.where(is_add, eq_r, wr))
        a2 = scatter(size, left, torch.where(is_add, wr, zero))
        del wr
        t.append(m.to_bytes(F.N_BYTES, "big"))
        rps1, u, ends = _rounds(t, torch.stack([g1, w, a2]), [[0, 1], [2]], bits)
        wu = ends[1]
        del g1, a2

        eu = F.mul(eq_r, eq_table(u, dev)[:, left])
        add_u = scatter(size, right, torch.where(is_add, eu, zero))
        mul_u = scatter(size, right, torch.where(is_add, zero, eu))
        del eu, eq_r, zero
        x = torch.stack([add_u, F.add(w, wu), F.mul(mul_u, wu), w])
        del add_u, mul_u
        rps2, v, _ = _rounds(t, x, [[0, 1], [2, 3]], bits)
        del x

        q = line(w, u, v)
        t.append(_elements(q[:2]))
        t.append(_elements(q))
        r_star = _challenge(t, bits)
        sc = RS.proof_bytes(m, rps1 + rps2)
        proof += len(sc).to_bytes(4, "big") + sc + _elements(q[:2]) + len(q).to_bytes(4, "big") + _elements(q)
        r = [(a + r_star * (b - a)) % F.P for a, b in zip(u, v)]
        m = F.lagrange_eval(q, r_star)
        levels[i] = None
    return bytes(proof), out_bytes


# --------------------------------------------------------------------------
# verifier
# --------------------------------------------------------------------------


def parse(data: bytes) -> tuple[bytes, list[tuple[int, list[list[int]], int, int, list[int]]]]:
    """(output bytes, per layer (claim, round polynomials, w_b, w_c, q's
    values)) of a proof's bytes; ValueError where they break the layout."""
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(data):
            raise ValueError("truncated GKR proof")
        off += n
        return data[off - n : off]

    def values(count: int) -> list[int]:
        raw = take(count * F.N_BYTES)
        return [int.from_bytes(raw[i * F.N_BYTES : (i + 1) * F.N_BYTES], "big") % F.P for i in range(count)]

    out_bytes = take(int.from_bytes(take(4), "big") * F.N_BYTES)
    layers = []
    for _ in range(int.from_bytes(take(4), "big")):
        claim, rps = RS.parse(take(int.from_bytes(take(4), "big")))
        w_b, w_c = values(2)
        layers.append((claim, rps, w_b, w_c, values(int.from_bytes(take(4), "big"))))
    if off != len(data):
        raise ValueError("trailing bytes in GKR proof")
    return out_bytes, layers


def wiring(circuit: Circuit, i: int, r: list[int], b: list[int], c: list[int]) -> tuple[int, int]:
    """add~_i and mul~_i at (r, b, c): the sums over the layer's add (mul)
    gates of eq(r, a) eq(b, left) eq(c, right)."""
    left, right, is_add = circuit.layers[i]
    dev = left.device
    w = F.mul(F.mul(eq_table(r, dev)[:, : len(left)], eq_table(b, dev)[:, left]), eq_table(c, dev)[:, right])
    zero = torch.zeros_like(w)
    return F.from_mont(F.total(torch.where(is_add, w, zero))), F.from_mont(F.total(torch.where(is_add, zero, w)))


def verify(circuit: Circuit, inputs: torch.Tensor, data: bytes, start=absorbed, bits: int | None = None) -> bool:
    """The verifier's decision on a proof's bytes: every round check, each
    layer's final value against the wiring predicates, the line's ends
    against w_b and w_c, and the last claim against the inputs' extension."""
    try:
        out_bytes, layers = parse(data)
    except ValueError:
        return False
    dev = inputs.device
    pad0 = 1 << circuit.k(0)
    if len(layers) != circuit.depth or len(out_bytes) > pad0 * F.N_BYTES:
        return False
    t = start(out_bytes)
    r = [_challenge(t, bits) for _ in range(circuit.k(0))]
    outputs = from_bytes(out_bytes, dev)
    m = F.evaluate(torch.nn.functional.pad(outputs, (0, pad0 - outputs.shape[-1])), r)
    for i, (claim, rps, w_b, w_c, q) in enumerate(layers):
        k_in = circuit.k(i + 1)
        if len(rps) != 2 * k_in or claim != m:
            return False
        ok, chs, final = RS.verify_rounds(claim, rps, t, challenge_bits=bits)
        if not ok:
            return False
        u, v = chs[:k_in], chs[k_in:]
        t.append(_elements([w_b, w_c]))
        add_e, mul_e = wiring(circuit, i, r, u, v)
        if (add_e * (w_b + w_c) + mul_e * w_b * w_c) % F.P != final:
            return False
        if len(q) != k_in + 1 or q[0] != w_b or (k_in >= 1 and q[1] != w_c):
            return False
        t.append(_elements(q))
        r_star = _challenge(t, bits)
        r = [(a + r_star * (b - a)) % F.P for a, b in zip(u, v)]
        m = F.lagrange_eval(q, r_star)
    x = torch.nn.functional.pad(inputs.to(torch.int64), (0, (1 << circuit.k(circuit.depth)) - circuit.n_inputs))
    return F.evaluate(x, r) == m
