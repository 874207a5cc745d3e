"""Sharded sumcheck jobs: a product of multilinear tables held across the
cards of one host, proved by every rank together, then verified.

A statement is a product of ``factors`` tables of 2^n_vars field elements
in the sharded layout of zk_tpu_torch.parallel: entry w * R + d of a table
lies on rank d of R, so a rank holds a (factors, 16, 2^n_vars / R) stack,
made on its own card from a seed derived from the run's seed and its rank.
The ranks run in lockstep through benchmark/mesh.py; rank 0 runs the
harness's loop and forwards every step.  One job:

  prove   every rank: ShardedSumcheckProver.prove_partial on a ShardedStack
          of its shard (the device transcript, one all_reduce a round);
          rank 0: proof_to_bytes;
  verify  rank 0: proof_from_bytes and SumcheckVerifier.verify_partial;
          every rank: MLE.evaluate of each factor's shard at the verifier's
          first n_vars - log2 R challenges (its shard is the table's
          multilinear extension over those variables at its rank's index
          bits); rank 0: the R values of each factor as an MLE over the
          last log2 R variables at the last challenges, the factors'
          product against the subclaim's sum.  The evaluations, with
          their hand-off to the ranks and back, are an ``oracle_eval``
          span.

The claimed sum is the sum of the ranks' reference sums over their shards.
The check replays every statement the window used in the plain reference
(benchmark/reference/sumcheck_mesh.py, every rank on its shard) and
compares every job's proof bytes, challenges, oracle values and the
verifier's decision, plus the decision on one altered proof a statement.
A job that raises on rank 0 ends the run, as one on any other rank does.
"""

from __future__ import annotations

import sys
from contextlib import nullcontext
from dataclasses import dataclass

import torch

from benchmark import inputs, mesh
from benchmark.jobs.sumcheck import CONTROL_BITS, tampered
from benchmark.reference import field as RF
from benchmark.reference import sumcheck as RS
from benchmark.reference import sumcheck_mesh as RM
from benchmark.reference.keccak import Transcript

NAMES = ("proof_bytes_wrong", "challenges_wrong", "oracle_wrong", "verdicts_wrong")


@dataclass
class State:
    mesh: object  # benchmark.mesh.Mesh
    field: object
    n_vars: int
    n_local: int  # variables a rank's shard spans
    degree: int
    claims: list


# -- every rank ----------------------------------------------------------


def rank_setup(ctx, config: dict, traffic: dict, seed: int) -> list[int]:
    """This rank's shard of every statement, made on its card; returns the
    reference's sum of each statement's factors' product over the shard."""
    from zk_tpu_torch import MLE
    from zk_tpu_torch.fields import ALL_FIELDS
    from zk_tpu_torch.parallel import make_mesh

    ctx.field = next(f for f in ALL_FIELDS if f.name == config["field"])
    ctx.mesh = make_mesh(ctx.ranks, device_type="cuda" if ctx.device.startswith("cuda") else "cpu")
    ctx.n_vars, ctx.n_local = config["n_vars"], config["n_vars"] - (ctx.ranks.bit_length() - 1)
    ctx.degree, k, pool, L = traffic["degree"], traffic["factors"], traffic["pool"], ctx.field.n_limbs
    gen = inputs.generator(seed * ctx.ranks + ctx.rank, ctx.device)
    ctx.tables = inputs.random_elements(gen, pool * k, 1 << ctx.n_local, L).reshape(pool, k, L, 1 << ctx.n_local)
    MLE(ctx.field, 1, ctx.tables[0, 0, :, :2].contiguous()).evaluate([1])  # builds or loads the kernels in set-up
    return [RS.claimed_sum(list(ctx.tables[i])) for i in range(pool)]


def rank_claims(ctx, claims: list[int]) -> None:
    ctx.claims = claims
    if ctx.device.startswith("cuda"):  # the peak is the statements' and the program's, not the claims' arithmetic
        torch.cuda.reset_peak_memory_stats()


def rank_prove(ctx, i: int):
    from zk_tpu_torch.parallel import ShardedStack, ShardedSumcheckProver

    stack = ShardedStack(ctx.mesh, ctx.field, (ctx.tables.shape[1],), ctx.n_vars, ctx.tables[i])
    proof, challenges = ShardedSumcheckProver.prove_partial(ctx.mesh, stack, ctx.claims[i], max_var_degree=ctx.degree)
    return (proof, challenges) if ctx.rank == 0 else None


def rank_oracle(ctx, i: int, point: list[int] | None) -> list[int] | None:
    """Each factor's shard, as an MLE over the first variables, at point."""
    from zk_tpu_torch import MLE

    if point is None:
        return None
    return [MLE(ctx.field, ctx.n_local, t).evaluate(point) for t in ctx.tables[i]]


def _exchange(obj) -> list:
    import torch.distributed as dist

    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def rank_replay(ctx, i: int, bits: int | None) -> dict | None:
    """The reference's proof of statement i (every rank on its shard)."""
    rps, chs, finals = RM.prove(list(ctx.tables[i]), ctx.degree, ctx.claims[i], Transcript(), _exchange, bits)
    return {"bytes": RS.proof_bytes(ctx.claims[i], rps), "challenges": chs, "oracle": finals} if ctx.rank == 0 else None


def rank_evaluate(ctx, i: int, point: list[int]) -> list[int]:
    """The reference's value of each factor's shard at point."""
    return [RM.evaluate_shard(t, point) for t in ctx.tables[i]]


# -- rank 0: the harness's kind ------------------------------------------


def setup(config: dict, traffic: dict, seed: int, device: str) -> State:
    m = mesh.start(config["ranks"], sys.modules[__name__], device)
    parts = m.call("setup", config, traffic, seed, timeout=mesh.SETUP_S)
    claims = [sum(col) % RF.P for col in zip(*parts)]
    m.call("claims", claims)
    ctx = m.ctx
    return State(m, ctx.field, config["n_vars"], ctx.n_local, ctx.degree, claims)


def _by_factor(by_rank: list[list[int]]) -> list[list[int]]:
    """Each factor's values, in rank order, from each rank's values."""
    return [[v[f] for v in by_rank] for f in range(len(by_rank[0]))]


def _mle_at(field, values: list[int], point: list[int]) -> int:
    """The multilinear extension of the ranks' values (rank index bits,
    most significant first) at point, in the program's field."""
    for r in point:
        h = len(values) // 2
        values = [field.add(a, field.mul(r, field.sub(b, a))) for a, b in zip(values[:h], values[h:])]
    return values[0]


def verdict(state: State, i: int, data: bytes, clock=None) -> tuple[bool, list | None]:
    """The program's verifier on a proof's bytes, with every rank's oracle
    values (in a job, an ``oracle_eval`` span): (accepted, each factor's
    value at the challenges)."""
    from zk_tpu_torch import SumcheckError, SumcheckVerifier, proof_from_bytes

    try:
        sub = SumcheckVerifier.verify_partial(state.field, proof_from_bytes(state.field, data))
    except (SumcheckError, ValueError):
        state.mesh.call("oracle", i, None)
        return False, None
    with clock.sub("oracle_eval") if clock is not None else nullcontext():
        by_rank = state.mesh.call("oracle", i, sub.challenges[: state.n_local])
    values = [_mle_at(state.field, v, sub.challenges[state.n_local :]) for v in _by_factor(by_rank)]
    product = 1
    for v in values:
        product = state.field.mul(product, v)
    return product == sub.sum, values


def job(state: State, i: int, clock) -> dict:
    from zk_tpu_torch import proof_to_bytes

    m = state.mesh
    try:
        with clock.sub("handoff"):
            m.send("prove", i)
        proof, challenges = rank_prove(m.ctx, i)
        data = proof_to_bytes(state.field, proof)
        clock.step("verify")
        accepted, values = verdict(state, i, data, clock)
    except Exception as exc:  # the other ranks wait inside a collective: the run cannot go on
        m.fail(f"rank 0 raised on statement {i}: {type(exc).__name__}: {exc}")
    return {"bytes": data, "challenges": challenges, "oracle": values, "accepted": accepted}


def reference_verdict(state: State, i: int, ref: dict, data: bytes, bits: int | None = None) -> bool:
    """The reference verifier's decision on a proof's bytes for statement i."""
    try:
        claim, rps = RS.parse(data)
    except ValueError:
        return False
    if len(rps) != state.n_vars:
        return False
    ok, chs, final = RS.verify_rounds(claim, rps, Transcript(), challenge_bits=bits)
    if not ok:
        return False
    if chs == ref["challenges"]:
        values = ref["oracle"]
    else:
        by_rank = state.mesh.call("evaluate", i, chs[: state.n_local])
        values = [RM.combine(v, chs[state.n_local :]) for v in _by_factor(by_rank)]
    product = 1
    for v in values:
        product = product * v % RF.P
    return product == final


def compare(state: State, records: list, refs: dict, verdicts: dict) -> list:
    wrong = dict.fromkeys(NAMES, 0)
    for i, rec in records:
        ref = refs[i]
        wrong["proof_bytes_wrong"] += rec["bytes"] != ref["bytes"]
        wrong["challenges_wrong"] += rec["challenges"] != ref["challenges"]
        wrong["oracle_wrong"] += rec["oracle"] != ref["oracle"]
        key = (i, rec["bytes"])
        if key not in verdicts:
            verdicts[key] = reference_verdict(state, i, ref, rec["bytes"])
        wrong["verdicts_wrong"] += rec["accepted"] != verdicts[key]
    return [(name, v, 0) for name, v in wrong.items()]


def _replay(state: State, i: int, bits: int | None = None) -> dict:
    return state.mesh.call("replay", i, bits, timeout=mesh.SETUP_S)[0]


def check(state: State, records: list) -> list:
    """[(name, value, limit)]: jobs whose output differs from the reference's."""
    state.mesh.report("prove", "oracle")  # the pipes' share of the window's steps
    used = sorted({i for i, _ in records})
    refs = {i: _replay(state, i) for i in used}
    verdicts: dict = {}
    out = compare(state, records, refs, verdicts)
    wrong = 0  # the program's verifier on an altered proof of each statement
    for i in used:
        bad = tampered(state, refs[i]["bytes"])
        wrong += verdict(state, i, bad)[0] != reference_verdict(state, i, refs[i], bad)
    out[-1] = ("verdicts_wrong", out[-1][1] + wrong, 0)
    return out


def control(state: State, statements: list) -> list:
    """The numbers of ``check`` with the control in the program's place: the
    reference whose challenges keep their low CONTROL_BITS bits only."""
    used = sorted(set(statements))
    refs = {i: _replay(state, i) for i in used}
    ctl = {i: _replay(state, i, CONTROL_BITS) for i in used}
    records = []
    for i in statements:
        accepted = reference_verdict(state, i, ctl[i], ctl[i]["bytes"], CONTROL_BITS)
        records.append((i, dict(ctl[i], accepted=accepted)))
    return compare(state, records, refs, {})

