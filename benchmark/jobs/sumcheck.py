"""Sumcheck jobs: prove a product of multilinear tables, then verify it.

A statement is a product of ``factors`` tables of 2^n_vars field elements
with the claimed sum the benchmark works out itself.  One job:

  prove   SumcheckProver.prove_partial (the program's default tier: on the
          card, the device transcript), then proof_to_bytes;
  verify  proof_from_bytes, SumcheckVerifier.verify_partial, and the oracle
          check: MLE.evaluate of each factor at the subclaim's challenges
          (each call an ``oracle_eval`` span), whose product must be the
          subclaim's sum.

The check replays every statement the window used in the plain reference
(benchmark/reference) and compares every job's proof bytes (the table
kernels' round polynomials), challenges (the transcript), oracle values
(the MLE evaluation) and the verifier's decision, plus the decision on one
altered proof a statement.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import torch

from benchmark import inputs
from benchmark.reference import field as RF
from benchmark.reference import sumcheck as RS
from benchmark.reference.keccak import Transcript

CONTROL_BITS = 128  # the control's challenges keep only their low 128 bits


@dataclass
class State:
    field: object
    n_vars: int
    degree: int
    tables: torch.Tensor  # (pool, factors, 16, 2^n_vars) int32 Montgomery limbs
    claims: list


def _port_field(name: str):
    from zk_tpu_torch.fields import ALL_FIELDS

    return next(f for f in ALL_FIELDS if f.name == name)


def setup(config: dict, traffic: dict, seed: int, device: str) -> State:
    field = _port_field(config["field"])
    n, k, pool = config["n_vars"], traffic["factors"], traffic["pool"]
    tables = inputs.random_elements(inputs.generator(seed, device), pool * k, 1 << n, field.n_limbs)
    tables = tables.reshape(pool, k, field.n_limbs, 1 << n)
    claims = [RS.claimed_sum(list(tables[i])) for i in range(pool)]
    if device.startswith("cuda"):  # the peak is the statements' and the program's, not the claims' arithmetic
        torch.cuda.reset_peak_memory_stats()
    return State(field, n, traffic["degree"], tables, claims)


def statement(state: State, i: int):
    """Statement i as the program takes it, wrapped afresh on every call, so
    that nothing the program might keep on its objects outlives a job."""
    from zk_tpu_torch import MLE, ProductPoly

    return ProductPoly([MLE(state.field, state.n_vars, t) for t in state.tables[i]])


def verdict(state: State, poly, data: bytes, clock=None) -> tuple[bool, object, list]:
    """The program's verifier on a proof's bytes: (accepted, subclaim, oracle values)."""
    from zk_tpu_torch import SumcheckError, SumcheckVerifier, proof_from_bytes

    try:
        sub = SumcheckVerifier.verify_partial(state.field, proof_from_bytes(state.field, data))
    except (SumcheckError, ValueError):
        return False, None, None
    values = []
    for mle in poly.polynomials:
        with clock.sub("oracle_eval") if clock is not None else nullcontext():
            values.append(mle.evaluate(sub.challenges))
    product = 1
    for v in values:
        product = state.field.mul(product, v)
    return product == sub.sum, sub, values


def job(state: State, i: int, clock) -> dict:
    from zk_tpu_torch import SumcheckProver, proof_to_bytes

    poly = statement(state, i)
    proof, challenges = SumcheckProver.prove_partial(poly, state.claims[i], max_var_degree=state.degree)
    data = proof_to_bytes(state.field, proof)
    clock.step("verify")
    accepted, _, values = verdict(state, poly, data, clock)
    return {"bytes": data, "challenges": challenges, "oracle": values, "accepted": accepted}


def _replay(state: State, i: int, bits: int | None = None) -> dict:
    tables = list(state.tables[i])
    rps, chs, finals = RS.prove(tables, state.degree, state.claims[i], Transcript(), challenge_bits=bits)
    return {"bytes": RS.proof_bytes(state.claims[i], rps), "challenges": chs, "oracle": finals}


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
    values = ref["oracle"] if chs == ref["challenges"] else [RF.evaluate(t, chs) for t in state.tables[i]]
    product = 1
    for v in values:
        product = product * v % RF.P
    return product == final


def tampered(state: State, data: bytes) -> bytes:
    """The proof with one value of its middle round changed."""
    per_round = 4 + RF.N_BYTES * (state.degree + 1)
    off = 4 + RF.N_BYTES + per_round * (state.n_vars // 2) + 4 + RF.N_BYTES - 1
    out = bytearray(data)
    out[off] ^= 1
    return bytes(out)


def compare(state: State, records: list, refs: dict, verdicts: dict) -> list:
    wrong = dict.fromkeys(("proof_bytes_wrong", "challenges_wrong", "oracle_wrong", "verdicts_wrong"), 0)
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


def check(state: State, records: list) -> list:
    """[(name, value, limit)]: jobs whose output differs from the reference's."""
    used = sorted({i for i, _ in records})
    refs = {i: _replay(state, i) for i in used}
    verdicts: dict = {}
    out = compare(state, records, refs, verdicts)
    wrong = 0  # the program's verifier on an altered proof of each statement
    for i in used:
        bad = tampered(state, refs[i]["bytes"])
        wrong += verdict(state, statement(state, i), bad)[0] != reference_verdict(state, i, refs[i], bad)
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
