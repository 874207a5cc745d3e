"""The upstream sumcheck prover over tables split across ranks, in plain
PyTorch, for the benchmark's reference.

Entry w * R + d of a 2^n table lies on rank d of R (the rank index is the
table index's last log2 R bits), so a rank's shard of 2^(n - log2 R)
entries is the table's restriction to the rank's index bits, and variable
0's pairs (w, w + W/2) lie inside a rank.  Every rank runs the same rounds
on its shard: ``sumcheck.round_values`` over its pairs, the ranks' sums
added as ints mod p, one transcript step, and the fold of its shard at the
challenge, until each shard is one entry a factor; the last log2 R rounds
run on host ints over the R gathered entries.  The rounds, challenges and
each factor's final value equal ``sumcheck.prove``'s on the whole table.
"""

from __future__ import annotations

import torch

from benchmark.reference import field as F
from benchmark.reference import sumcheck as S


def fold_blocks(t: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``field.fold`` of a (16, 2^k) table in blocks of pairs, into a fresh
    (16, 2^(k-1)) int32 table: nothing of the table's size in int64."""
    h = t.shape[-1] // 2
    out = torch.empty((F.LIMBS, h), dtype=torch.int32, device=t.device)
    for s in range(0, h, F.CHUNK):
        e = min(h, s + F.CHUNK)
        lo, hi = t[..., s:e].to(torch.int64), t[..., h + s : h + e].to(torch.int64)
        out[..., s:e] = F.add(lo, F.mul(col, F.sub(hi, lo)))
    return out


def _fold_host(values: list[int], r: int) -> list[int]:
    """Fix the most significant index bit of a host table (canonical) at r."""
    h = len(values) // 2
    return [(a + r * (b - a)) % F.P for a, b in zip(values[:h], values[h:])]


def combine(values: list[int], point: list[int]) -> int:
    """The multilinear extension of one value a rank (canonical, in rank
    order) at the last log2 R challenges."""
    for r in point:
        values = _fold_host(values, r)
    return values[0]


def evaluate_shard(t: torch.Tensor, point: list[int]) -> int:
    """A shard's multilinear extension at point (canonical), folding in
    blocks."""
    for r in point:
        t = fold_blocks(t, F.column(F.to_mont(r), t.device))
    return F.from_mont(F.ints(t)[0])


def _host_values(tables: list[list[int]], degree: int) -> list[int]:
    """The round polynomial at t = 0..degree of the factors' product, over
    host tables of canonical ints."""
    h = len(tables[0]) // 2
    out = []
    for t in range(degree + 1):
        acc = 0
        for x in range(h):
            prod = 1
            for tab in tables:
                prod = prod * (tab[x] + t * (tab[h + x] - tab[x])) % F.P
            acc += prod
        out.append(acc % F.P)
    return out


def prove(shards: list[torch.Tensor], degree: int, claim: int, transcript, exchange,
          challenge_bits: int | None = None) -> tuple[list[list[int]], list[int], list[int]]:
    """Every round of a sumcheck of ``claim`` over this rank's factor
    shards, as ``sumcheck.prove`` returns them for the whole tables.
    ``exchange(obj)`` returns every rank's obj in rank order; every rank
    calls ``prove`` with the same arguments but its shards."""
    transcript.append(claim.to_bytes(F.N_BYTES, "big"))
    round_polys, challenges = [], []

    def step(values: list[int]) -> int:
        transcript.append(b"".join(v.to_bytes(F.N_BYTES, "big") for v in values))
        r = transcript.challenge(F.P)
        if challenge_bits is not None:
            r &= (1 << challenge_bits) - 1
        round_polys.append(values)
        challenges.append(r)
        return r

    tables = list(shards)
    for _ in range(tables[0].shape[-1].bit_length() - 1):
        sums = exchange(S.round_values(tables, degree))
        r = step([F.from_mont(sum(col) % F.P) for col in zip(*sums)])
        col = F.column(F.to_mont(r), tables[0].device)
        tables = [fold_blocks(t, col) for t in tables]
    ends = exchange([F.from_mont(F.ints(t)[0]) for t in tables])
    host = [[e[f] for e in ends] for f in range(len(tables))]  # per factor, one entry a rank
    while len(host[0]) > 1:
        r = step(_host_values(host, degree))
        host = [_fold_host(tab, r) for tab in host]
    return round_polys, challenges, [tab[0] for tab in host]
