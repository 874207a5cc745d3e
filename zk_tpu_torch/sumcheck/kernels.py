"""Round-sum normalisation, the device Fiat-Shamir round, and the host
tail of the sumcheck prover.

Counterpart of ``zk_tpu.sumcheck.kernels``.  The table kernels
(``capacity``) return (P, L, G) int64 partial accumulators: raw sums of
the 16-bit Montgomery limbs of every contribution.  Their value is a sum
of Montgomery representatives, i.e. (true sum) * R modulo p, so:

  * ``canon_sums`` (on the device) adds the G partials in int64 and turns
    each point's wide limb vector into its canonical field element with
    one batched Montgomery product against the 2^(16 j) weights
    (``fields.device.renorm_wide``);
  * ``decode_sums`` (on the host) does the same with Python ints.

``transcript_round`` is the per-round Fiat-Shamir step on the device:
canonical sums -> big-endian bytes -> absorb -> squeeze -> challenge.  On
a CUDA tensor it is one launch of csrc/transcript.cu; on a CPU tensor it
runs ``transcript_round_plain``, the same step as torch ops.
``HostTables`` is the exact host-int tier that finishes small tables.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from zk_tpu_torch import _cuda
from zk_tpu_torch.fields.field import Field, LIMB_BITS
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.kernels import check_cuda, cuda_stream, field_params
from zk_tpu_torch.sumcheck.capacity import MAX_PARTIALS
from zk_tpu_torch.transcript import device as tdev
from zk_tpu_torch.utils.stat import to_host

TAIL_SIZE = 2048  # tables at/below this size finish on host ints


def canon_sums(field: Field, partials: torch.Tensor) -> torch.Tensor:
    """(P, L, G) int64 partials -> (L, P) canonical int32 limbs of the P
    true sums.  Lane sums stay exact in int64 (< 2^40 per limb)."""
    cols = partials.sum(dim=-1).t()  # (L, P): limb j of every point
    return dev.renorm_wide(field, cols, mont_out=False)


def decode_sums(field: Field, partials: torch.Tensor) -> list[int]:
    """(P, L, G) int64 partials -> P canonical ints (host)."""
    totals = to_host(partials.sum(dim=-1)).tolist()
    rinv = pow(field.R, -1, field.p)
    out = []
    for row in totals:
        v = sum(int(limb) << (LIMB_BITS * i) for i, limb in enumerate(row))
        out.append((v * rinv) % field.p)
    return out


def transcript_round_plain(field: Field, pos: int, lo, hi, buf, partials: torch.Tensor):
    """The per-round Fiat-Shamir step as torch ops: canonicalize the
    round-poly sums ((D+1, L, G) partials), absorb their BE bytes, squeeze
    the challenge (prover.rs:59-62, byte-exact with the host Transcript).

    Returns (lo, hi, buf, round sums (L, D+1) canonical, challenge
    canonical (L, 1), challenge Montgomery (L, 1)).  The new pos is always
    32 (finalize_reset re-absorbs the digest)."""
    total = canon_sums(field, partials)
    data = tdev.serialize_canonical(field, total)
    lo, hi, buf, pos2 = tdev.absorb(lo, hi, buf, pos, data)
    lo, hi, buf, _pos3, digest = tdev.sample_challenge(lo, hi, buf, pos2)
    mont, canon = tdev.challenge_from_digest(field, digest)
    return lo, hi, buf, total, canon, mont


@functools.lru_cache(maxsize=None)
def _round_params(field: Field) -> np.ndarray:
    """csrc/transcript.cu RoundParams: field.cuh's block, then R^2 mod p."""
    nw = field.n_limbs // 2
    r2 = [(field.R2 >> (32 * w)) & 0xFFFFFFFF for w in range(nw)]
    return np.concatenate([field_params(field), np.array(r2, dtype=np.uint32)])


@functools.lru_cache(maxsize=None)
def _round_params_ptr(field: Field) -> int:
    return _round_params(field).ctypes.data


def transcript_round_args(field: Field, partials: int, P: int, G: int, sponge, pos: int, out, stream):
    """zk_transcript_round's arguments from data pointers: ``sponge`` the
    (lo, hi, buf) read, ``out`` the (lo, hi, buf, sums, canonical
    challenge, Montgomery challenge) written."""
    lo, hi, buf = sponge
    out_lo, out_hi, out_buf, total, canon, mont = out
    return (field.n_limbs, partials, P, G, lo, hi, buf, pos, _round_params_ptr(field), out_lo, out_hi,
            out_buf, total, canon, mont, stream)


def transcript_round(field: Field, pos: int, lo, hi, buf, partials: torch.Tensor):
    """One Fiat-Shamir round of the device prover, the same function as
    ``transcript_round_plain``: one launch of csrc/transcript.cu on a CUDA
    tensor, the plain version on a CPU tensor, ValueError on any other.
    Replaces the round that zk_tpu jits around
    zk_tpu/transcript/device.py::_rounds_kernel_pallas.  The outputs are
    fresh tensors; nothing waits on the card."""
    P, L, G = partials.shape
    if field.p <= (1 << 32):
        raise ValueError("device transcript requires p > 2^32")
    if partials.dtype != torch.int64 or L != field.n_limbs or not 1 <= P <= 4:
        raise ValueError(f"transcript_round: partials must be int64 (D+1 <= 4, {field.n_limbs}, G)")
    if not 0 <= pos < tdev.RATE:
        raise ValueError(f"transcript_round: pos {pos} not in [0, {tdev.RATE})")
    if partials.device.type == "cpu":
        return transcript_round_plain(field, pos, lo, hi, buf, partials)
    check_cuda(field, "transcript_round", partials, lo, hi, buf)
    if G > MAX_PARTIALS or field.n_bytes != 2 * L:
        raise ValueError(f"transcript_round: no kernel for G = {G} partials of {field.name}")
    if lo.dtype != torch.int64 or hi.dtype != torch.int64 or buf.dtype != torch.int64:
        raise ValueError("transcript_round: the sponge must be int64 tensors")
    out = (torch.empty_like(lo), torch.empty_like(hi), torch.empty_like(buf),
           torch.empty((L, P), dtype=torch.int32, device=partials.device),
           torch.empty((L, 1), dtype=torch.int32, device=partials.device),
           torch.empty((L, 1), dtype=torch.int32, device=partials.device))
    err = _cuda.lib().zk_transcript_round(*transcript_round_args(
        field, partials.data_ptr(), P, G, (lo.data_ptr(), hi.data_ptr(), buf.data_ptr()), pos,
        [t.data_ptr() for t in out], cuda_stream(partials),
    ))
    _cuda.check(err, "transcript_round")
    _cuda.count_launch("transcript_round")
    return tuple(out)


class HostTables:
    """Factor tables as Python int lists: terms -> factors -> evals."""

    def __init__(self, field: Field, terms: list[list[list[int]]]):
        self.field = field
        self.terms = terms

    @classmethod
    def of_rows(cls, field: Field, ks, ints: list[int], n: int) -> "HostTables":
        """Rows of n ints, one factor a row, split into the terms ks."""
        rows = [ints[i : i + n] for i in range(0, len(ints), n)]
        terms, row = [], 0
        for k in ks:
            terms.append(rows[row : row + k])
            row += k
        return cls(field, terms)

    @property
    def size(self) -> int:
        return len(self.terms[0][0])

    def round_sums(self, degree: int) -> list[int]:
        f = self.field
        half = self.size // 2
        sums = []
        for point in range(degree + 1):
            total = 0
            for term in self.terms:
                for e in range(half):
                    prod = 1
                    for fac in term:
                        left, right = fac[e], fac[e + half]
                        if point == 0:
                            ev = left
                        elif point == 1:
                            ev = right
                        else:
                            ev = (left - point * (left - right)) % f.p
                        prod = (prod * ev) % f.p
                    total = (total + prod) % f.p
            sums.append(total)
        return sums

    def rounds(self, degree: int, count: int, transcript, round_polys, challenges) -> None:
        """``count`` rounds in exact ints: sums, absorb, challenge, fold."""
        host = self
        for _ in range(count):
            round_poly = host.round_sums(degree)
            transcript.append(self.field.elements_to_bytes(round_poly))
            challenge = transcript.sample_field_element(self.field)
            host = host.fold(challenge)
            round_polys.append(round_poly)
            challenges.append(challenge)

    def fold(self, r: int) -> "HostTables":
        f = self.field
        half = self.size // 2
        return HostTables(
            f,
            [
                [[(fac[e] - r * (fac[e] - fac[e + half])) % f.p for e in range(half)] for fac in term]
                for term in self.terms
            ],
        )
