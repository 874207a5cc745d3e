"""Mesh-sharded sumcheck prover: the same proofs as ``SumcheckProver``.

Counterpart of ``zk_tpu.parallel.sumcheck``.  Layout: a 2^n table is
viewed as (W, D) with flat index w * D + d, and rank d of a D-rank mesh
holds ``table[..., d::D]``, a (K, L, W) stack.  The D axis is the LAST
log2(D) index bits (the late variables); the W axis holds the early
variables, which the prover folds first.  A rank's stack is therefore
exactly a single-device stack: the fold of variable 0 pairs local
(w, w + W/2), so the table kernels (``fold``, ``fold_halfsums``,
``round_sums``, ``round_sums_terms``, ``fold_multi``) run unchanged on it
and a round needs one collective: the ``all_reduce`` of its round sums.

Round sums are int64 partials whose limb lanes stay below 2^41 for any
table the prover takes (``sumcheck.capacity.partition``); a rank adds
its partials over G and the mesh adds the (D+1, L) lanes exactly in
int64, with no limb conversion.  Every rank then runs the same
Fiat-Shamir step on the same sums and holds the same sponge and
challenge, with no broadcast.  A device round is one ``transcript_round``,
one ``all_reduce`` and the single-device round's table kernels.

Once the local table is down to ``max(2, tail / D)`` entries the shards
are gathered (one ``all_gather``) into the natural-order table
(e = w * D + d) on every rank, and the remaining rounds run as the
single-device prover's, from the same sponge state: on the card every
round stays on the device (its tail rule); on the CPU the default tail is
2 D, so the gathered table finishes on host ints.  The transcript,
challenges and bytes equal ``SumcheckProver``'s for every tail: sharding
is invisible to the verifier.
"""

from __future__ import annotations

import torch

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.parallel.mesh import MeshGroup
from zk_tpu_torch.poly.product import terms_of
from zk_tpu_torch.sumcheck import (
    SumcheckProof,
    SumcheckProver,
    _decode_host_tables,
    absorb_poly,
    chain_rounds,
    host_rounds,
)
from zk_tpu_torch.sumcheck import kernels as K
from zk_tpu_torch.sumcheck.record import RoundRecord
from zk_tpu_torch.transcript import Transcript


class ShardedStack:
    """A polynomial's factor tables held in the sharded layout across
    proves: this rank's (K, L, W) stack of the terms ks.  Build it with
    ``ShardedSumcheckProver.shard``; ``prove_partial`` and ``prove`` take
    it in place of the polynomial (each prove that folds in place works
    on a copy)."""

    __slots__ = ("mesh", "field", "ks", "n_vars", "stack")

    def __init__(self, mesh, field: Field, ks: tuple, n_vars: int, stack: torch.Tensor):
        self.mesh = mesh
        self.field = field
        self.ks = ks
        self.n_vars = n_vars
        self.stack = stack


def _local_stack(group: MeshGroup, poly) -> tuple[tuple, torch.Tensor]:
    """(ks, this rank's (K, L, W) stack) of a polynomial's tables."""
    field: Field = poly.field
    n, D = 1 << poly.n_vars, group.size
    if D & (D - 1):
        raise ValueError(f"sharded sumcheck requires a power-of-two mesh, got {D}")
    if n < 2 * D:
        raise ValueError("table too small to shard over this mesh")
    terms = terms_of(poly)
    L = field.n_limbs
    flat = [t.reshape(L, n // D, D)[:, :, group.index] for term in terms for t in term]
    return tuple(len(t) for t in terms), torch.stack(flat)


class ShardedSumcheckProver:
    """``SumcheckProver`` over a mesh: the same proofs, one ``all_reduce``
    a round.  Every rank of the mesh calls it with the same arguments."""

    @staticmethod
    def shard(mesh, poly) -> ShardedStack:
        """This rank's shard of a polynomial's factor tables, for reuse
        across proves; proof bytes are the same either way."""
        ks, stack = _local_stack(MeshGroup(mesh), poly)
        return ShardedStack(mesh, poly.field, ks, poly.n_vars, stack)

    @staticmethod
    def prove_partial(mesh, poly, sum: int, max_var_degree: int | None = None,
                      device_transcript: bool | None = None, tail_size: int | None = None):
        """Prove without binding the initial poly; returns (proof,
        challenges)."""
        return ShardedSumcheckProver._prove_internal(
            mesh, poly, sum, Transcript(), max_var_degree, device_transcript, tail_size=tail_size
        )

    @staticmethod
    def prove(mesh, poly, sum: int, max_var_degree: int | None = None,
              device_transcript: bool | None = None, tail_size: int | None = None) -> SumcheckProof:
        """Prove, binding the initial poly's bytes (a ShardedStack carries
        only its shard, so it needs prove_partial)."""
        if isinstance(poly, ShardedStack):
            raise ValueError("prove binds the whole polynomial's bytes: pass the polynomial")
        transcript = Transcript()
        absorb_poly(transcript, poly)
        proof, _ = ShardedSumcheckProver._prove_internal(
            mesh, poly, sum, transcript, max_var_degree, device_transcript, tail_size=tail_size
        )
        return proof

    @staticmethod
    def _prove_internal(mesh, poly, sum: int, transcript: Transcript, max_var_degree: int | None = None,
                        device_transcript: bool | None = None, bind_sum: bool = True,
                        tail_size: int | None = None) -> tuple[SumcheckProof, list[int]]:
        """bind_sum=False skips the claimed-sum binding (the second phase
        of a GKR layer).  tail_size is the global table size at or below
        which the remaining rounds run on host ints, as SumcheckProver's;
        the default is the single-device rule on the card and 2 D on the
        CPU."""
        group = MeshGroup(mesh)
        D = group.size
        field: Field = poly.field
        if isinstance(poly, ShardedStack):
            if poly.mesh is not mesh and poly.mesh != mesh:
                raise ValueError("ShardedStack was built for a different mesh")
            ks = poly.ks
            degree = max_var_degree if max_var_degree is not None else max(ks)
            # a degree-1 single-factor prove writes fresh buffers; any other folds in place
            stack = poly.stack if (degree, ks) == (1, (1,)) else poly.stack.clone()
        else:
            ks, stack = _local_stack(group, poly)
            degree = max_var_degree if max_var_degree is not None else poly.max_degree
        if bind_sum:
            transcript.append(field.to_bytes_be(sum))
        n_vars = poly.n_vars
        device = stack.device
        if device_transcript is None:
            device_transcript = device.type == "cuda" and field.p > (1 << 32)
        device_transcript = device_transcript and field.p > (1 << 32)
        if tail_size is not None:
            tail = tail_size
        elif device.type == "cuda":
            tail = 1 if device_transcript else K.TAIL_SIZE
        else:
            tail = 2 * D
        local_tail = max(2, tail // D)

        def reduce(partials):
            return group.all_reduce(partials.sum(dim=-1, keepdim=True))

        def gather(local):  # (K, L, W) shards -> (K, L, W * D), natural order e = w * D + d
            return group.all_gather(local).permute(1, 2, 3, 0).reshape(local.shape[:2] + (-1,))

        round_polys: list[list[int]] = []
        challenges: list[int] = []
        sharded = chain_rounds(stack.shape[-1], local_tail, n_vars)
        if device_transcript:
            # one record for both phases: the sharded rounds, then the gathered table's
            W = stack.shape[-1]
            gathered = (W >> sharded) * D
            rounds = chain_rounds(gathered, tail, n_vars - sharded)
            record = RoundRecord(field, degree, ks, device, (W, sharded, True),
                                 (gathered, rounds, sharded + rounds < n_vars))
            record.upload(*transcript.export_state())
            stack = record.queue(stack, reduce=reduce)
            record.read(transcript, round_polys, challenges, n_vars, record.queue(gather(stack)))
            host = None
        else:
            if sharded:
                stack = SumcheckProver._synced_rounds(
                    field, degree, ks, stack, n_vars, local_tail, transcript, round_polys, challenges, reduce=reduce
                )
            table = gather(stack)
            if table.shape[-1] > tail:
                table = SumcheckProver._synced_rounds(
                    field, degree, ks, table, n_vars, tail, transcript, round_polys, challenges
                )
            host = None if table is None else _decode_host_tables(field, ks, table)

        host_rounds(field, degree, host, n_vars, transcript, round_polys, challenges)
        return SumcheckProof(sum=sum, round_polys=round_polys), challenges
