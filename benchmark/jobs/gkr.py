"""GKR jobs: prove that a layered circuit maps a statement's inputs to its
outputs, then verify the proof.

The circuit is built once from the configuration (the matrix product
C = A B of ``n`` x ``n`` matrices, ``reference.gkr.matmul``) and handed
to the program as numpy wiring (``Circuit.from_arrays``); a deployment
proves many statements of one circuit, so the program's own cache of the
circuit's device wiring lives across jobs.  A statement is an
(L, n_inputs) Montgomery tensor of random inputs on the card.  One job:

  prove   GKRProver.prove (the program's default path: on the card, the
          device-resident layer chain), then gkr_proof_to_bytes; the
          returned wire levels are dropped;
  verify  gkr_proof_from_bytes, then GKRVerifier.verify.

The check replays every statement the window used once in the plain
reference (benchmark/reference/gkr.py) and counts the jobs whose outputs,
whose proof bytes, or whose verifier's decision differ from the
reference's; the decisions are also compared on one altered proof a
statement (one byte of the middle layer's sumcheck flipped).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from benchmark import inputs
from benchmark.reference import field as RF
from benchmark.reference import gkr as RG

CONTROL_BITS = 128  # the control's challenges keep only their low 128 bits


@dataclass
class State:
    field: object
    circuit: object  # the program's Circuit
    wiring: RG.Circuit  # the same circuit for the reference, on the host
    inputs: torch.Tensor  # (pool, 16, n_inputs) int32 Montgomery limbs


def setup(config: dict, traffic: dict, seed: int, device: str) -> State:
    from zk_tpu_torch import Circuit
    from zk_tpu_torch.fields import ALL_FIELDS

    field = next(f for f in ALL_FIELDS if f.name == config["field"])
    wiring = RG.matmul(config["n"])
    circuit = Circuit.from_arrays([tuple(t.numpy() for t in layer) for layer in wiring.layers], wiring.n_inputs)
    statements = inputs.random_elements(inputs.generator(seed, device), traffic["pool"], wiring.n_inputs,
                                        field.n_limbs)
    return State(field, circuit, wiring, statements)


def verdict(state: State, i: int, data: bytes) -> bool:
    """The program's verifier on a proof's bytes for statement i."""
    from zk_tpu_torch import GKRVerifier, SumcheckError
    from zk_tpu_torch.gkr import GKRError, gkr_proof_from_bytes

    try:
        return GKRVerifier.verify(state.field, state.circuit, state.inputs[i], gkr_proof_from_bytes(state.field, data))
    except (GKRError, SumcheckError, ValueError):
        return False


def job(state: State, i: int, clock) -> dict:
    from zk_tpu_torch import GKRProver
    from zk_tpu_torch.gkr import gkr_proof_to_bytes

    proof = GKRProver.prove(state.field, state.circuit, state.inputs[i])[0]
    data = gkr_proof_to_bytes(state.field, proof)
    clock.step("verify")
    return {"bytes": data, "outputs": proof.outputs, "accepted": verdict(state, i, data)}


class Absorbed:
    """Transcripts that have absorbed a proof's output bytes, made once a
    distinct output and copied for each use: the plain Keccak takes
    seconds over 2^16 outputs."""

    def __init__(self):
        self.seen: dict[bytes, object] = {}

    def __call__(self, out_bytes: bytes):
        if out_bytes not in self.seen:
            self.seen[out_bytes] = RG.absorbed(out_bytes)
        return copy.deepcopy(self.seen[out_bytes])


class Reference:
    """The reference's proofs and decisions for the statements of a check,
    on the statements' device."""

    def __init__(self, state: State):
        self.state = state
        self.circuit = state.wiring.to(state.inputs.device)
        self.start = Absorbed()
        self.verdicts: dict = {}

    def prove(self, i: int, bits: int | None = None) -> dict:
        data, out_bytes = RG.prove(self.circuit, self.state.inputs[i], self.start, bits)
        return {"bytes": data, "outputs": out_bytes}

    def verdict(self, i: int, data: bytes, bits: int | None = None) -> bool:
        key = (i, data, bits)
        if key not in self.verdicts:
            self.verdicts[key] = RG.verify(self.circuit, self.state.inputs[i], data, self.start, bits)
        return self.verdicts[key]


def tampered(data: bytes) -> bytes:
    """The proof with the last byte of the first value of the middle round
    of the middle layer's sumcheck flipped."""
    def u32(at: int) -> int:
        return int.from_bytes(data[at : at + 4], "big")

    off = 4 + u32(0) * RF.N_BYTES
    depth = u32(off)
    off += 4
    for _ in range(depth // 2):
        off += 4 + u32(off) + 2 * RF.N_BYTES
        off += 4 + u32(off) * RF.N_BYTES
    sc = off + 4
    per_round = 4 + 3 * RF.N_BYTES
    at = sc + 4 + RF.N_BYTES + per_round * (u32(sc) // 2) + 4 + RF.N_BYTES - 1
    out = bytearray(data)
    out[at] ^= 1
    return bytes(out)


def _outputs_bytes(outputs: list[int]) -> bytes:
    return b"".join(v.to_bytes(RF.N_BYTES, "big") for v in outputs)


def compare(ref: Reference, records: list, refs: dict) -> list:
    wrong = dict.fromkeys(("outputs_wrong", "proof_bytes_wrong", "verdicts_wrong"), 0)
    for i, rec in records:
        wrong["outputs_wrong"] += _outputs_bytes(rec["outputs"]) != refs[i]["outputs"]
        wrong["proof_bytes_wrong"] += rec["bytes"] != refs[i]["bytes"]
        wrong["verdicts_wrong"] += rec["accepted"] != ref.verdict(i, rec["bytes"])
    return [(name, v, 0) for name, v in wrong.items()]


def check(state: State, records: list) -> list:
    """[(name, value, limit)]: jobs whose output differs from the reference's."""
    ref = Reference(state)
    used = sorted({i for i, _ in records})
    refs = {i: ref.prove(i) for i in used}
    out = compare(ref, records, refs)
    wrong = 0  # the program's verifier on an altered proof of each statement
    for i in used:
        bad = tampered(refs[i]["bytes"])
        wrong += verdict(state, i, bad) != ref.verdict(i, bad)
    out[-1] = ("verdicts_wrong", out[-1][1] + wrong, 0)
    return out


def control(state: State, statements: list) -> list:
    """The numbers of ``check`` with the control in the program's place: the
    reference whose challenges keep their low CONTROL_BITS bits only."""
    ref = Reference(state)
    used = sorted(set(statements))
    refs = {i: ref.prove(i) for i in used}
    ctl = {i: ref.prove(i, CONTROL_BITS) for i in used}
    records = []
    for i in statements:
        accepted = ref.verdict(i, ctl[i]["bytes"], CONTROL_BITS)
        outputs = [int.from_bytes(ctl[i]["outputs"][j : j + RF.N_BYTES], "big")
                   for j in range(0, len(ctl[i]["outputs"]), RF.N_BYTES)]
        records.append((i, {"bytes": ctl[i]["bytes"], "outputs": outputs, "accepted": accepted}))
    return compare(ref, records, refs)
