"""GKR: the layered-circuit interactive proof, one sumcheck per layer.

Counterpart of ``zk_tpu.gkr``, with the same proofs, serialization and
accept/reject decisions.  Per layer i, with claim m_i = W~_i(r_i), the
prover runs a sumcheck over (b, c) in {0,1}^{2k} of

  f(b,c) = add~_i(r_i,b,c) * (W~_{i+1}(b) + W~_{i+1}(c))
         + mul~_i(r_i,b,c) *  W~_{i+1}(b) * W~_{i+1}(c)

as two k-round phases over 2^k-entry tables (``gkr.device``); the two
claims W(b*), W(c*) reduce to one through the line restriction
q(t) = W~(b* + t (c* - b*)): the verifier checks q(0), q(1), samples r*,
and continues with m_{i+1} = q(r*) at r_{i+1} = b* + r* (c* - b*).  The
final claim is checked against the input MLE.

Fiat-Shamir layout: output bytes -> sample r_0 -> per layer [sumcheck
transcript -> w_b, w_c bytes -> q evals bytes -> sample r*].

Provers: the device-resident chain (``gkr.chain``, one host sync per
prove) by default on the card for p > 2^32; the per-phase prover (its
sumchecks in any tier of ``SumcheckProver``) otherwise, with
``device_transcript=False``, or over a mesh (``ShardedSumcheckProver``);
``prove_dense``, the O(4^k) differential oracle.  All give the same
bytes.  The provers' stages are ``zk.gkr.*`` spans (``utils.stat``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from dataclasses import field as dc_field

import torch

from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.gkr import device as gdev
from zk_tpu_torch.gkr.circuit import ADD, MUL, Circuit, Gate  # noqa: F401
from zk_tpu_torch.parallel import ShardedSumcheckProver
from zk_tpu_torch.poly.hypercube import binary_string
from zk_tpu_torch.poly.mle import MLE
from zk_tpu_torch.poly.product import ProductPoly, SumOfProducts
from zk_tpu_torch.poly.univariate import UnivariatePolynomial
from zk_tpu_torch.sumcheck import (
    SumcheckProof,
    SumcheckProver,
    SumcheckVerifier,
    proof_from_bytes,
    proof_to_bytes,
)
from zk_tpu_torch.transcript import Transcript
from zk_tpu_torch.utils.stat import span


class GKRError(Exception):
    pass


@dataclass
class LayerProof:
    sumcheck: SumcheckProof
    w_b: int
    w_c: int
    q_evals: list[int]  # q(0..k) on the line through (b*, c*)


@dataclass
class GKRProof:
    outputs: list[int]
    layer_proofs: list[LayerProof]
    # the output bytes as received (gkr_proof_from_bytes): the transcript
    # binds what was received, so a non-canonical encoding of an output
    # changes the challenges; excluded from equality
    outputs_bytes: bytes | None = dc_field(default=None, compare=False)


def _received_outputs_bytes(field: Field, proof: GKRProof) -> bytes | None:
    """The received output bytes where they encode every output, else None
    (the condition of zk_tpu/gkr/__init__.py:389-392 and :470-472)."""
    ob = proof.outputs_bytes
    return ob if ob is not None and len(ob) == len(proof.outputs) * field.n_bytes else None


# --------------------------------------------------------------------------
# eq / MLE helpers (host ints)
# --------------------------------------------------------------------------


def eq_weight(field: Field, point: list[int], bits: str) -> int:
    """eq(point, bits) = prod_j (p_j b_j + (1-p_j)(1-b_j))."""
    acc = 1
    for p_j, ch in zip(point, bits):
        acc = field.mul(acc, p_j if ch == "1" else (1 - p_j) % field.p)
    return acc


def mle_eval_host(field: Field, values: list[int], point: list[int]) -> int:
    """The MLE of a padded value vector at a point (host ints, successive
    folds from var 0 = MSB, as evaluation_form.rs)."""
    vals = [v % field.p for v in values]
    for r in point:
        half = len(vals) // 2
        vals = [(vals[e] - r * (vals[e] - vals[e + half])) % field.p for e in range(half)]
    return vals[0]


def _wiring_eval_host(field: Field, circuit: Circuit, layer: int, op: str, point: list[int]) -> int:
    """add~_i or mul~_i at (r, b, c) from the circuit structure: the sum of
    eq terms over the layer's gates of that op."""
    k_out, k_in = circuit.layer_k(layer), circuit.layer_k(layer + 1)
    r, b_pt, c_pt = point[:k_out], point[k_out : k_out + k_in], point[k_out + k_in :]
    total = 0
    for a, gate in enumerate(circuit.layers[layer]):
        if gate.op != op:
            continue
        w = eq_weight(field, r, binary_string(a, k_out))
        w = field.mul(w, eq_weight(field, b_pt, binary_string(gate.left, k_in)))
        w = field.mul(w, eq_weight(field, c_pt, binary_string(gate.right, k_in)))
        total = field.add(total, w)
    return total


def _layer_claims(field: Field, transcript: Transcript, b_star, c_star, q_evals):
    """Absorb q_evals, sample r*, and return the next layer's (r, m)."""
    transcript.append(field.elements_to_bytes(q_evals))
    r_star = transcript.sample_field_element(field)
    r = [(b + r_star * (c - b)) % field.p for b, c in zip(b_star, c_star)]
    return r, UnivariatePolynomial.interpolate(field, q_evals).evaluate(r_star)


def _dense_layer_poly(field: Field, circuit: Circuit, layer: int, r: list[int], w_below: list[int], device):
    """The layer polynomial over explicit (b, c) tables of 4^k entries:
    add_r (W(b) + W(c)) + mul_r W(b) W(c), index (b, c) = b 2^k + c."""
    k_in, k_out = circuit.layer_k(layer + 1), circuit.layer_k(layer)
    size_in = 1 << k_in
    add_vals = [0] * (size_in * size_in)
    mul_vals = [0] * (size_in * size_in)
    for a, gate in enumerate(circuit.layers[layer]):
        vals = add_vals if gate.op == ADD else mul_vals
        pos = gate.left * size_in + gate.right
        vals[pos] = field.add(vals[pos], eq_weight(field, r, binary_string(a, k_out)))
    w_dev = dev.encode_ints(field, w_below, device=device)
    wb = w_dev.repeat_interleave(size_in, dim=1)
    wc = w_dev.repeat(1, size_in)
    n = 2 * k_in
    return SumOfProducts([
        ProductPoly([MLE.new(field, n, add_vals, device), MLE(field, n, dev.add_mod(field, wb, wc))]),
        ProductPoly([MLE.new(field, n, mul_vals, device), MLE(field, n, wb), MLE(field, n, wc)]),
    ])


# --------------------------------------------------------------------------
# prover
# --------------------------------------------------------------------------


class GKRProver:
    @staticmethod
    def prove(
        field: Field,
        circuit: Circuit,
        inputs,
        tail_size: int | None = None,
        device_transcript: bool | None = None,
        device=None,
        mesh=None,
    ) -> tuple[GKRProof, list[torch.Tensor]]:
        """Prove circuit(inputs) = outputs; returns (proof, device wire
        levels).  ``inputs``: host ints, encoded onto ``device`` (the card
        unless another is named), or an (L, n_inputs) Montgomery tensor,
        whose device is used.  The device-resident chain runs by default
        on CUDA for p > 2^32 (or where device_transcript=True); the
        per-phase prover otherwise, its two sumchecks per layer in the
        tiers of ``SumcheckProver``.

        With a mesh (every rank calling with the same arguments) the
        per-phase prover runs: the witness is gate-sharded and every phase
        sumcheck over at least 2 x mesh-size entries runs through
        ``ShardedSumcheckProver``; smaller ones run single-device, as the
        reference's.  The proof bytes are the single-device proof's."""
        d = inputs.device if isinstance(inputs, torch.Tensor) else dev.resolve_device(device)
        big_field = field.p > (1 << 32)
        if device_transcript is None:
            device_transcript = d.type == "cuda" and big_field
        if (
            mesh is None
            and device_transcript
            and big_field
            and tail_size is None
            and all(circuit.layer_k(i + 1) >= 1 for i in range(circuit.depth))
        ):
            from zk_tpu_torch.gkr.chain import prove_chain

            return prove_chain(field, circuit, inputs, d)

        with span("zk.gkr.witness"):
            levels = gdev.evaluate_device(circuit, field, inputs, d, mesh=mesh)
            nb, n_out = field.n_bytes, len(circuit.layers[0])
            out_bytes = dev.decode_bytes_be(field, levels[0])[: n_out * nb]
            outputs = [int.from_bytes(out_bytes[i * nb : (i + 1) * nb], "big") for i in range(n_out)]

        transcript = Transcript()
        with span("zk.gkr.bind_outputs"):
            transcript.append(out_bytes)
            r = transcript.sample_n_field_elements(field, circuit.layer_k(0))
            m = dev.decode_ints(field, gdev.mle_eval_points(field, levels[0], [r]))[0]

        tiers = dict(max_var_degree=2, tail_size=tail_size, device_transcript=device_transcript)
        layer_proofs: list[LayerProof] = []
        for i in range(circuit.depth):
            k_in = circuit.layer_k(i + 1)
            w_dev = levels[i + 1]
            if mesh is not None and (1 << k_in) >= 2 * mesh.size():
                prove_phase = functools.partial(ShardedSumcheckProver._prove_internal, mesh)
            else:
                prove_phase = SumcheckProver._prove_internal
            with span("zk.gkr.eq_r_table"):
                eq_r = gdev.eq_table(field, r, d)

            # phase 1: sum over b of G1(b) W(b) + A2(b); binds the claim
            with span("zk.gkr.phase1_tables"):
                poly1 = gdev.build_phase1(field, circuit, i, eq_r, w_dev)
            with span("zk.gkr.phase1_sumcheck"):
                proof1, u = prove_phase(poly1, m, transcript, **tiers)
            m2 = UnivariatePolynomial.interpolate(field, proof1.round_polys[-1]).evaluate(u[-1]) if u else m

            # phase 2: sum over c with b fixed at u (the claim is bound)
            with span("zk.gkr.phase2_tables"):
                poly2, _ = gdev.build_phase2(field, circuit, i, eq_r, u, w_dev)
            with span("zk.gkr.phase2_sumcheck"):
                proof2, v = prove_phase(poly2, m2, transcript, bind_sum=False, **tiers)

            with span("zk.gkr.line_restriction"):
                q_evals = gdev.line_restriction_evals(field, w_dev, u, v)
            w_b, w_c = q_evals[0], q_evals[min(1, k_in)]
            transcript.append(field.elements_to_bytes([w_b, w_c]))
            r, m_next = _layer_claims(field, transcript, u, v, q_evals)
            layer_proofs.append(LayerProof(
                sumcheck=SumcheckProof(sum=m, round_polys=proof1.round_polys + proof2.round_polys),
                w_b=w_b, w_c=w_c, q_evals=q_evals,
            ))
            m = m_next
        return GKRProof(outputs=outputs, layer_proofs=layer_proofs, outputs_bytes=out_bytes), levels

    @staticmethod
    def prove_dense(field: Field, circuit: Circuit, inputs: list[int], device=None) -> tuple[GKRProof, list[list[int]]]:
        """The dense prover over explicit (b, c) factor tables of 4^k
        entries (on ``device``, the card unless another is named): the
        differential oracle for ``prove`` (identical bytes)."""
        d = dev.resolve_device(device)
        levels = circuit.evaluate(field, inputs)
        outputs = levels[0][: len(circuit.layers[0])]

        transcript = Transcript()
        transcript.append(field.elements_to_bytes(outputs))
        r = transcript.sample_n_field_elements(field, circuit.layer_k(0))
        m = mle_eval_host(field, levels[0], r)

        layer_proofs: list[LayerProof] = []
        for i in range(circuit.depth):
            k_in = circuit.layer_k(i + 1)
            poly = _dense_layer_poly(field, circuit, i, r, levels[i + 1], d)
            proof, challenges = SumcheckProver._prove_internal(poly, m, transcript, max_var_degree=2)
            b_star, c_star = challenges[:k_in], challenges[k_in:]
            q_evals = [
                mle_eval_host(field, levels[i + 1], [(b + t * (c - b)) % field.p for b, c in zip(b_star, c_star)])
                for t in range(k_in + 1)
            ]
            w_b, w_c = q_evals[0], q_evals[min(1, k_in)]
            transcript.append(field.elements_to_bytes([w_b, w_c]))
            r, m_next = _layer_claims(field, transcript, b_star, c_star, q_evals)
            layer_proofs.append(LayerProof(sumcheck=proof, w_b=w_b, w_c=w_c, q_evals=q_evals))
            m = m_next
        return GKRProof(outputs=outputs, layer_proofs=layer_proofs), levels


# --------------------------------------------------------------------------
# serialization (canonical BE, the conventions of sumcheck.proof_to_bytes)
# --------------------------------------------------------------------------


def gkr_proof_to_bytes(field: Field, proof: GKRProof) -> bytes:
    out = bytearray()
    out += len(proof.outputs).to_bytes(4, "big")
    out += _received_outputs_bytes(field, proof) or field.elements_to_bytes(proof.outputs)
    out += len(proof.layer_proofs).to_bytes(4, "big")
    for lp in proof.layer_proofs:
        sc = proof_to_bytes(field, lp.sumcheck)
        out += len(sc).to_bytes(4, "big")
        out += sc
        out += field.elements_to_bytes([lp.w_b, lp.w_c])
        out += len(lp.q_evals).to_bytes(4, "big")
        out += field.elements_to_bytes(lp.q_evals)
    return bytes(out)


def gkr_proof_from_bytes(field: Field, data: bytes) -> GKRProof:
    nb = field.n_bytes
    off = 0

    def u32() -> int:
        nonlocal off
        off += 4
        return int.from_bytes(data[off - 4 : off], "big")

    def elems(count: int) -> list[int]:
        nonlocal off
        out = [field.from_be_bytes_mod_order(data[off + i * nb : off + (i + 1) * nb]) for i in range(count)]
        off += count * nb
        return out

    n_out = u32()
    outputs_bytes = data[off : off + n_out * nb]
    outputs = elems(n_out)
    layer_proofs = []
    for _ in range(u32()):
        sc_len = u32()
        sc = proof_from_bytes(field, data[off : off + sc_len])
        off += sc_len
        w_b, w_c = elems(2)
        layer_proofs.append(LayerProof(sumcheck=sc, w_b=w_b, w_c=w_c, q_evals=elems(u32())))
    if off != len(data):
        raise ValueError("trailing bytes in serialized GKR proof")
    return GKRProof(outputs=outputs, layer_proofs=layer_proofs, outputs_bytes=outputs_bytes)


# --------------------------------------------------------------------------
# verifier
# --------------------------------------------------------------------------

_DEVICE_MIN = 4096  # value vectors above this size are folded on the device
_DEVICE_GATES = 256  # layers with more gates check their wiring on the device


def _layer_value(field: Field, add_e: int, mul_e: int, w_b: int, w_c: int) -> int:
    """add~ (w_b + w_c) + mul~ w_b w_c: the layer polynomial at (b*, c*)."""
    return field.add(field.mul(add_e, field.add(w_b, w_c)), field.mul(mul_e, field.mul(w_b, w_c)))


class GKRVerifier:
    @staticmethod
    def verify(field: Field, circuit: Circuit, inputs, proof: GKRProof, device=None) -> bool:
        """Verify a GKR proof against the circuit and inputs (host ints or
        an (L, n_inputs) Montgomery tensor).  Raises GKRError or
        SumcheckError on a malformed or inconsistent proof; returns False
        on a final-claim mismatch (the sumcheck error semantics).  Large
        value vectors and layers are evaluated on ``device`` (the card
        unless another is named; an input tensor's own device)."""
        if len(proof.layer_proofs) != circuit.depth:
            raise GKRError("invalid proof: require one layer proof per circuit layer")
        d = inputs.device if isinstance(inputs, torch.Tensor) else dev.resolve_device(device)

        # the transcript binds the output bytes as received; the output
        # table is encoded from the canonical bytes of the values
        received = _received_outputs_bytes(field, proof)
        pad_n = 1 << circuit.layer_k(0)
        canon = field.elements_to_bytes(proof.outputs) if received is None or pad_n > _DEVICE_MIN else None
        transcript = Transcript()
        transcript.append(received if received is not None else canon)
        r = transcript.sample_n_field_elements(field, circuit.layer_k(0))
        if pad_n > _DEVICE_MIN:
            pad = b"\x00" * ((pad_n - len(proof.outputs)) * field.n_bytes)
            out_dev = dev.encode_bytes_be(field, canon + pad, device=d)
            m = dev.decode_ints(field, gdev.mle_eval_points(field, out_dev, [r]))[0]
        else:
            m = mle_eval_host(field, proof.outputs + [0] * (pad_n - len(proof.outputs)), r)

        # oracle checks of large layers run on the device; their decodes
        # wait for one read after the host transcript loop (the values feed
        # only the checks, never the Fiat-Shamir chain)
        deferred = []
        for i, lp in enumerate(proof.layer_proofs):
            k_in = circuit.layer_k(i + 1)
            if len(lp.sumcheck.round_polys) != 2 * k_in:
                raise GKRError("invalid layer proof: wrong sumcheck round count")
            if lp.sumcheck.sum % field.p != m:
                raise GKRError("layer claim does not match running claim")
            subclaim = SumcheckVerifier._verify_internal(field, lp.sumcheck, transcript)
            b_star, c_star = subclaim.challenges[:k_in], subclaim.challenges[k_in:]
            transcript.append(field.elements_to_bytes([lp.w_b, lp.w_c]))

            if len(circuit.layers[i]) > _DEVICE_GATES:
                handle = gdev.wiring_eval_async(field, circuit, i, r, b_star, c_star, d)
                deferred.append((handle, lp.w_b, lp.w_c, subclaim.sum))
            else:
                point = r + b_star + c_star
                add_e = _wiring_eval_host(field, circuit, i, ADD, point)
                mul_e = _wiring_eval_host(field, circuit, i, MUL, point)
                if _layer_value(field, add_e, mul_e, lp.w_b, lp.w_c) != subclaim.sum:
                    raise GKRError("layer oracle check failed")

            if len(lp.q_evals) != k_in + 1:
                raise GKRError("invalid layer proof: wrong q eval count")
            if lp.q_evals[0] % field.p != lp.w_b or (k_in >= 1 and lp.q_evals[1] % field.p != lp.w_c):
                raise GKRError("line restriction inconsistent with claimed w values")
            r, m = _layer_claims(field, transcript, b_star, c_star, lp.q_evals)

        # the final claim against the input MLE
        pad_to = 1 << circuit.layer_k(circuit.depth)
        if isinstance(inputs, torch.Tensor):
            got = gdev.mle_eval_points(field, torch.nn.functional.pad(inputs, (0, pad_to - inputs.shape[-1])), [r])
        else:
            padded = [v % field.p for v in inputs] + [0] * (pad_to - len(inputs))
            got = None
            if pad_to > _DEVICE_MIN:
                got = gdev.mle_eval_points(field, dev.encode_ints(field, padded, device=d), [r])

        # one read for every deferred oracle value and the input evaluation
        handles = [h for h, *_ in deferred] + ([got] if got is not None else [])
        values = dev.decode_ints(field, torch.cat(handles, dim=1)) if handles else []
        for j, (_, w_b, w_c, claimed) in enumerate(deferred):
            if _layer_value(field, values[2 * j], values[2 * j + 1], w_b, w_c) != claimed:
                raise GKRError("layer oracle check failed")
        if got is not None:
            return values[-1] == m
        return mle_eval_host(field, padded, r) == m
