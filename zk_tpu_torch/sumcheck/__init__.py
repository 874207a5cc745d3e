"""Non-interactive sumcheck via Fiat-Shamir — prover and verifier.

Counterpart of ``zk_tpu.sumcheck`` (sumcheck/src/{lib,prover,verifier}.rs),
with the same proofs, challenges and serialization.  Prover tiers, picked
per table:

  * device transcript (default on CUDA for p > 2^32): every round on the
    device — round sums, Fiat-Shamir absorb/squeeze, fused fold — queued
    into one planned round record, with one host sync at the end of the
    prove (``record.RoundRecord``);
  * synced (device_transcript=False): the same table kernels, but the
    sums come to the host every round and the host Transcript absorbs and
    squeezes — the differential tier for the device transcript;
  * host: tables at or below ``tail_size`` finish in exact Python ints.

The polynomial is a ProductPoly or a SumOfProducts of any degree up to
``capacity.MAX_DEGREE``.  Degree-1 single-factor tables run the fused
fold-and-half-sums round; every other shape runs its terms concatenated
in one stack, with a fold and a (sum-of-products) round-sums kernel per
round.

Error semantics match the reference: a failed round check raises
SumcheckError (verifier.rs:61-66), a failed oracle check returns False.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.transcript import Transcript
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.poly.product import terms_of
from zk_tpu_torch.poly.univariate import UnivariatePolynomial
from zk_tpu_torch.sumcheck import capacity as C
from zk_tpu_torch.sumcheck import kernels as K
from zk_tpu_torch.sumcheck.record import RoundRecord
from zk_tpu_torch.utils.stat import span, to_host


class SumcheckError(Exception):
    """Raised where the reference returns Err(&'static str)."""


@dataclass
class SumcheckProof:
    """sumcheck/src/lib.rs:8-11."""

    sum: int
    round_polys: list[list[int]]


@dataclass
class SubClaim:
    """sumcheck/src/lib.rs:13-20: the deferred oracle check
    sum == initial_poly(challenges)."""

    sum: int
    challenges: list[int]


_ABSORB_CHUNK = 1 << 20  # elements per transcript-absorb fetch


def absorb_poly(transcript: Transcript, poly) -> None:
    """Absorb a polynomial's canonical bytes, every factor of every term
    (prover.rs:17 / the verifier's poly binding), in 2^20-element chunks
    (canonical BE bytes concatenate per element, so chunking is
    byte-identical)."""
    for term in terms_of(poly):
        for data in term:
            for a in range(0, data.shape[-1], _ABSORB_CHUNK):
                transcript.append(dev.decode_bytes_be(poly.field, data[:, a : a + _ABSORB_CHUNK]))


def _canonical_rows(field: Field, table) -> torch.Tensor:
    """(rows, L, n) Montgomery factor rows -> (L, rows * n) canonical limbs
    on the table's device (one mont_mul launch on a card)."""
    rows, L, n = table.shape
    return dev._canonical(field, table.permute(1, 0, 2).reshape(L, rows * n), True)


def _decode_host_tables(field: Field, ks, table) -> K.HostTables:
    """(sum(ks), L, n) Montgomery factor rows -> HostTables split into the
    terms ks: un-scaled where they lie, then one read."""
    return K.HostTables.of_rows(field, ks, dev.host_ints(field, to_host(_canonical_rows(field, table)), mont=False),
                                table.shape[-1])


class SumcheckProver:
    """sumcheck/src/prover.rs:9-69.  max_var_degree plays the role of the
    reference's MAX_VAR_DEGREE (round-poly sample points minus one) and
    defaults to the factor count."""

    @staticmethod
    def prove(
        poly,
        sum: int,
        max_var_degree: int | None = None,
        tail_size: int | None = None,
        device_transcript: bool | None = None,
    ) -> SumcheckProof:
        """Prove, binding the initial poly bytes (prover.rs:15-20)."""
        transcript = Transcript()
        absorb_poly(transcript, poly)
        proof, _ = SumcheckProver._prove_internal(
            poly, sum, transcript, max_var_degree, tail_size, device_transcript
        )
        return proof

    @staticmethod
    def prove_partial(
        poly,
        sum: int,
        max_var_degree: int | None = None,
        tail_size: int | None = None,
        device_transcript: bool | None = None,
    ) -> tuple[SumcheckProof, list[int]]:
        """Prove without binding the initial poly (prover.rs:24-30);
        returns (proof, challenges)."""
        return SumcheckProver._prove_internal(
            poly, sum, Transcript(), max_var_degree, tail_size, device_transcript
        )

    @staticmethod
    def _prove_internal(
        poly,
        sum: int,
        transcript: Transcript,
        max_var_degree: int | None = None,
        tail_size: int | None = None,
        device_transcript: bool | None = None,
        bind_sum: bool = True,
    ) -> tuple[SumcheckProof, list[int]]:
        """prover.rs:33-69 round loop across the three tiers.  bind_sum=False
        skips the claimed-sum binding: the second phase of a two-phase GKR
        layer continues a sumcheck already bound (the verifier absorbs the
        sum once per layer proof, verifier.rs:50)."""
        with span("zk.prove"):
            field: Field = poly.field
            degree = max_var_degree if max_var_degree is not None else poly.max_degree
            tail = K.TAIL_SIZE if tail_size is None else tail_size
            if bind_sum:
                transcript.append(field.to_bytes_be(sum))

            round_polys: list[list[int]] = []
            challenges: list[int] = []
            n_vars = poly.n_vars
            size = 1 << n_vars
            terms = terms_of(poly)
            ks = tuple(len(t) for t in terms)
            device = terms[0][0].device
            default = device.type == "cuda"
            device_transcript = field.p > (1 << 32) and (default if device_transcript is None else device_transcript)
            host_tables = None

            if size > tail and n_vars > 0:
                with span("zk.prove.start"):
                    L = field.n_limbs
                    if (degree, ks) == (1, (1,)):
                        stack = terms[0][0].reshape(1, L, size)  # a view: never written
                    else:  # a fresh buffer, folded in place
                        stack = torch.cat([t.reshape(1, L, size) for term in terms for t in term])
                    if device_transcript:
                        record = SumcheckProver._plan(field, degree, ks, size, n_vars, tail, tail_size is None, device)
                        record.upload(*transcript.export_state())
                if device_transcript:
                    record.read(transcript, round_polys, challenges, n_vars, record.queue(stack))
                else:
                    table = SumcheckProver._synced_rounds(
                        field, degree, ks, stack, n_vars, tail, transcript, round_polys, challenges
                    )
                    host_tables = None if table is None else _decode_host_tables(field, ks, table)

            if len(challenges) < n_vars and host_tables is None:
                host_tables = K.HostTables(field, [[dev.decode_ints(field, t) for t in term] for term in terms])
            host_rounds(field, degree, host_tables, n_vars, transcript, round_polys, challenges)
            return SumcheckProof(sum=sum, round_polys=round_polys), challenges

    @staticmethod
    def _plan(field, degree, ks, size, n_vars, tail, default_tail, device) -> RoundRecord:
        """Device-resident Fiat-Shamir: the round record of a prove, planned
        with its device rounds.  Every round is queued into the record and ONE host
        sync at the end reads the round polys, challenges, sponge state
        (and the table, when a host tail follows).  On CUDA every round
        runs on the device; on the CPU the last tables of up to 128
        elements finish on host ints, as in the reference (there a device
        round is hundreds of small torch ops, dearer than the host tail's
        bigint products).  An explicit tail_size wins."""
        if default_tail:
            chain_tail = 1 if device.type == "cuda" else min(128, tail)
        else:
            chain_tail = tail
        rounds = chain_rounds(size, chain_tail, n_vars)
        return RoundRecord(field, degree, ks, device, (size, rounds, rounds < n_vars))

    @staticmethod
    def _synced_rounds(field, degree, ks, stack, n_vars, tail, transcript, round_polys, challenges, reduce=None):
        """Per-round-synced tier: the same table kernels, with the round
        sums read back and absorbed by the host Transcript every round,
        while the table is larger than ``tail``.  Returns the live table
        (None once every round is done).  ``reduce`` as in
        ``record.RoundRecord.queue``."""
        size = stack.shape[-1]
        deg1 = (degree, ks) == (1, (1,))
        acc = C.term_sums(field, degree, ks, stack, size)
        owned = not deg1  # a degree-1 prove's first fold writes a fresh buffer
        while size > tail:
            with span("zk.prove.round"):
                round_poly = K.decode_sums(field, acc if reduce is None else reduce(acc))
                transcript.append(field.elements_to_bytes(round_poly))
                challenge = transcript.sample_field_element(field)
                round_polys.append(round_poly)
                challenges.append(challenge)
                if len(challenges) == n_vars:
                    return None  # the last round needs no fold
                r = dev.scalar(field, challenge, device=stack.device)
                out = stack if owned else stack.new_empty((1, field.n_limbs, size // 2))
                if deg1:
                    stack, acc = C.fold_halfsums(field, stack, size, r, out=out)  # size >= 4 here
                else:
                    stack = C.fold(field, stack, size, r, out=out)
                    if size // 2 > tail:
                        acc = C.term_sums(field, degree, ks, stack, size // 2)
                owned = True
                size //= 2
        return stack[:, :, :size]


def host_rounds(field, degree, host, n_vars, transcript, round_polys, challenges) -> None:
    """The rounds left of n_vars, on HostTables in exact ints."""
    if len(challenges) == n_vars:
        return
    with span("zk.prove.decode"):
        host.rounds(degree, n_vars - len(challenges), transcript, round_polys, challenges)


def chain_rounds(size: int, chain_tail: int, n_vars: int) -> int:
    """Rounds that halve a table of ``size`` entries while it is larger
    than ``chain_tail``, at most n_vars."""
    rounds = 0
    while size > chain_tail and rounds < n_vars:
        rounds += 1
        size //= 2
    return rounds


# --------------------------------------------------------------------------
# serialization
# --------------------------------------------------------------------------


def proof_to_bytes(field: Field, proof: SumcheckProof) -> bytes:
    """u32 round count, sum, then per round u32 eval count + canonical BE
    elements (zk_tpu.sumcheck.proof_to_bytes)."""
    with span("zk.proof.to_bytes"):
        out = bytearray()
        out += len(proof.round_polys).to_bytes(4, "big")
        out += field.to_bytes_be(proof.sum)
        for rp in proof.round_polys:
            out += len(rp).to_bytes(4, "big")
            out += field.elements_to_bytes(rp)
        return bytes(out)


def proof_from_bytes(field: Field, data: bytes) -> SumcheckProof:
    with span("zk.proof.from_bytes"):
        off = 0
        n_rounds = int.from_bytes(data[off : off + 4], "big")
        off += 4
        s = field.from_be_bytes_mod_order(data[off : off + field.n_bytes])
        off += field.n_bytes
        round_polys = []
        for _ in range(n_rounds):
            cnt = int.from_bytes(data[off : off + 4], "big")
            off += 4
            rp = []
            for _ in range(cnt):
                rp.append(field.from_be_bytes_mod_order(data[off : off + field.n_bytes]))
                off += field.n_bytes
            round_polys.append(rp)
        if off != len(data):
            raise ValueError("trailing bytes in serialized proof")
        return SumcheckProof(sum=s, round_polys=round_polys)


# --------------------------------------------------------------------------
# verifier
# --------------------------------------------------------------------------


class SumcheckVerifier:
    """sumcheck/src/verifier.rs:9-79; exact host-int round checks."""

    @staticmethod
    def verify(poly, proof: SumcheckProof) -> bool:
        """Full verification incl. the oracle check (verifier.rs:15-33).
        Raises SumcheckError on a failed round check; returns False on a
        failed oracle check."""
        if len(proof.round_polys) != poly.n_vars:
            raise SumcheckError("invalid proof: require 1 round poly for each variable in poly")
        transcript = Transcript()
        absorb_poly(transcript, poly)
        subclaim = SumcheckVerifier._verify_internal(poly.field, proof, transcript)
        return poly.evaluate(subclaim.challenges) == subclaim.sum

    @staticmethod
    def verify_partial(field: Field, proof: SumcheckProof) -> SubClaim:
        """All checks except the oracle check (verifier.rs:38-41)."""
        return SumcheckVerifier._verify_internal(field, proof, Transcript())

    @staticmethod
    def _verify_internal(field: Field, proof: SumcheckProof, transcript: Transcript) -> SubClaim:
        """verifier.rs:44-78."""
        with span("zk.verify"):
            challenges: list[int] = []
            transcript.append(field.to_bytes_be(proof.sum))
            claimed_sum = proof.sum % field.p
            for round_poly in proof.round_polys:
                transcript.append(field.elements_to_bytes(round_poly))
                uni = UnivariatePolynomial.interpolate(field, round_poly)
                if claimed_sum != field.add(uni.evaluate(0), uni.evaluate(1)):
                    raise SumcheckError("verifier check failed: claimed_sum != p(0) + p(1)")
                challenge = transcript.sample_field_element(field)
                claimed_sum = uni.evaluate(challenge)
                challenges.append(challenge)
            return SubClaim(sum=claimed_sum, challenges=challenges)
