"""The upstream sumcheck prover (prove_partial) and its serialization, in
plain PyTorch, for the benchmark's reference.

A polynomial is a product of multilinear factor tables (16, 2^n) of
Montgomery limbs (``field``).  Round j sends the round polynomial's
values at t = 0..degree, each the sum over the pair index x of the
factors' product of f(t, x) = lo(x) + t (hi(x) - lo(x)),
where lo and hi are the halves of a factor by its variable 0; it absorbs
them, samples the challenge, and fixes variable 0 of every factor at it.
"""

from __future__ import annotations

import torch

from benchmark.reference import field as F
from benchmark.reference.keccak import Transcript


def round_values(tables: list[torch.Tensor], degree: int) -> list[int]:
    """The round polynomial at t = 0..degree (Montgomery ints) of the
    factors' product, summed in blocks of pairs."""
    n = tables[0].shape[-1]
    h = n // 2
    sums = [0] * (degree + 1)
    for s in range(0, h, F.CHUNK):
        e = min(h, s + F.CHUNK)
        at_t = []  # at_t[t][i]: factor i at t over this block
        lo = [t[..., s:e].to(torch.int64) for t in tables]
        hi = [t[..., h + s : h + e].to(torch.int64) for t in tables]
        at_t.append(lo)
        at_t.append(hi)
        if degree >= 2:
            diff = [F.sub(b, a) for a, b in zip(lo, hi)]
            for _ in range(2, degree + 1):
                at_t.append([F.add(v, d) for v, d in zip(at_t[-1], diff)])
        for t in range(degree + 1):
            prod = at_t[t][0]
            for v in at_t[t][1:]:
                prod = F.mul(prod, v)
            sums[t] = (sums[t] + F.total(prod)) % F.P
    return sums


def prove(
    tables: list[torch.Tensor],
    degree: int,
    claim: int,
    transcript: Transcript,
    challenge_bits: int | None = None,
) -> tuple[list[list[int]], list[int], list[int]]:
    """Every round of a sumcheck of ``claim`` (canonical).  Returns the
    round polynomials (canonical), the challenges, and each factor's value
    at the challenges (canonical).  ``challenge_bits`` keeps only the low
    bits of each challenge: the control's broken guarantee."""
    transcript.append(claim.to_bytes(F.N_BYTES, "big"))
    round_polys, challenges = [], []
    n_vars = tables[0].shape[-1].bit_length() - 1
    for _ in range(n_vars):
        values = [F.from_mont(v) for v in round_values(tables, degree)]
        transcript.append(b"".join(v.to_bytes(F.N_BYTES, "big") for v in values))
        r = transcript.challenge(F.P)
        if challenge_bits is not None:
            r &= (1 << challenge_bits) - 1
        round_polys.append(values)
        challenges.append(r)
        col = F.column(F.to_mont(r), tables[0].device)
        tables = [F.fold(t.to(torch.int64), col) for t in tables]
    finals = [F.from_mont(F.ints(t)[0]) for t in tables]
    return round_polys, challenges, finals


def proof_bytes(claim: int, round_polys: list[list[int]]) -> bytes:
    """The sumcheck proof's bytes: u32 round count, the claim, then per
    round a u32 value count and the values, big-endian."""
    out = bytearray(len(round_polys).to_bytes(4, "big"))
    out += claim.to_bytes(F.N_BYTES, "big")
    for rp in round_polys:
        out += len(rp).to_bytes(4, "big")
        out += b"".join(v.to_bytes(F.N_BYTES, "big") for v in rp)
    return bytes(out)


def claimed_sum(tables: list[torch.Tensor]) -> int:
    """The sum over the hypercube of the factors' product (canonical): the
    claim the benchmark hands the prover."""
    n = tables[0].shape[-1]
    acc = 0
    for s in range(0, n, F.CHUNK):
        prod = tables[0][..., s : s + F.CHUNK].to(torch.int64)
        for t in tables[1:]:
            prod = F.mul(prod, t[..., s : s + F.CHUNK].to(torch.int64))
        acc = (acc + F.total(prod)) % F.P
    return F.from_mont(acc)


def parse(data: bytes) -> tuple[int, list[list[int]]]:
    """(claim, round polynomials) of a proof's bytes (ValueError where they
    do not follow ``proof_bytes``'s layout)."""
    nb, off = F.N_BYTES, 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(data):
            raise ValueError("truncated sumcheck proof")
        off += n
        return data[off - n : off]

    n_rounds = int.from_bytes(take(4), "big")
    claim = int.from_bytes(take(nb), "big") % F.P
    rps = []
    for _ in range(n_rounds):
        cnt = int.from_bytes(take(4), "big")
        raw = take(cnt * nb)
        rps.append([int.from_bytes(raw[i * nb : (i + 1) * nb], "big") % F.P for i in range(cnt)])
    if off != len(data):
        raise ValueError("trailing bytes in sumcheck proof")
    return claim, rps


def verify_rounds(claim: int, round_polys: list[list[int]], transcript: Transcript,
                  challenge_bits: int | None = None) -> tuple[bool, list[int], int]:
    """The verifier's round checks (p(0) + p(1) = the running claim): (all
    held, challenges, the final claim), the checks stopping at the first
    that fails."""
    transcript.append(claim.to_bytes(F.N_BYTES, "big"))
    running, challenges = claim % F.P, []
    for rp in round_polys:
        transcript.append(b"".join(v.to_bytes(F.N_BYTES, "big") for v in rp))
        if len(rp) < 2 or (rp[0] + rp[1]) % F.P != running:
            return False, challenges, running
        r = transcript.challenge(F.P)
        if challenge_bits is not None:
            r &= (1 << challenge_bits) - 1
        running = F.lagrange_eval(rp, r)
        challenges.append(r)
    return True, challenges, running
