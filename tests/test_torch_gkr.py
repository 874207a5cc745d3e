"""The port's GKR prover and verifier against zk_tpu, exact (tolerance 0).

The same seeded circuits and inputs go to both packages, each with its own
field and circuit objects (``interop.circuit_from_jax``).  BLS12-381 proofs
are held against the JAX package's frozen output
(tests/goldens/gkr_d3w8_prove.bin, checked by tests/test_goldens.py); JAX's
jitted GKR code runs here only over Goldilocks and at the smallest shapes,
where it compiles in seconds.  Wiring predicates are held against the
exact host-int ``zk_tpu.gkr._wiring_eval_host``.
"""

import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_tpu import fields as jfields
from zk_tpu import gkr as jgkr
from zk_tpu.fields import device as jdev
from zk_tpu.gkr import circuit as jcircuit
from zk_tpu.gkr import device as jgdev
from zk_tpu_torch import GKRProver, GKRVerifier, interop
from zk_tpu_torch.fields import BLS12_381_FR, GOLDILOCKS
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.gkr import (
    GKRError,
    GKRProof,
    _wiring_eval_host,
    gkr_proof_from_bytes,
    gkr_proof_to_bytes,
    mle_eval_host,
)
from zk_tpu_torch.gkr import device as gdev
from zk_tpu_torch.gkr.chain import prove_chain
from zk_tpu_torch.gkr.circuit import Circuit, Gate
from zk_tpu_torch.sumcheck import SumcheckError

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
JG = jfields.GOLDILOCKS  # each package gets its own field object
JF = {f.name: f for f in (jfields.GOLDILOCKS, jfields.BLS12_381_FR)}
TF = {f.name: f for f in (GOLDILOCKS, BLS12_381_FR)}


def random_circuit(rng, depth, width, n_inputs, gate=Gate):
    """tests/test_gkr.py's seeded layered circuit, in either package."""
    layers = []
    below = n_inputs
    for d in range(depth):
        size = width if d < depth - 1 else max(1, width // 2)
        layers.append([
            gate("add" if rng.random() < 0.5 else "mul", rng.randrange(below), rng.randrange(below))
            for _ in range(size)
        ])
        below = size
    layers.reverse()
    return layers


def d3w8(field):
    """The golden circuit: random.Random(7), depth 3, width 8, 8 inputs."""
    rng = random.Random(7)
    c = Circuit(random_circuit(rng, 3, 8, 8), n_inputs=8)
    return c, [rng.randrange(field.p) for _ in range(8)]


def two_layer():
    """out = (a+b)*(c*d); middle layer = [a+b, c*d] (tests/test_gkr.py)."""
    return Circuit([[Gate("mul", 0, 1)], [Gate("add", 0, 1), Gate("mul", 2, 3)]], n_inputs=4)


def high_fanin():
    """One 128-gate layer over 64 wires whose left children crowd on a few
    wires (fan-in above zk_tpu.gkr.device._GATHER_FANIN_MAX = 64 on both
    sides' busiest wire), over 64 inputs."""
    rng = random.Random(17)
    top = [jcircuit.Gate("add" if a % 3 else "mul", rng.choice([0, 0, 0, 5]), rng.choice([1, 1, 2, rng.randrange(64)]))
           for a in range(128)]
    mid = [jcircuit.Gate("mul" if a % 2 else "add", rng.randrange(64), rng.randrange(64)) for a in range(64)]
    return jcircuit.Circuit([top, mid], n_inputs=64)


# --------------------------------------------------------------------------
# the device tier's pieces against zk_tpu.gkr.device (Goldilocks, small)
# --------------------------------------------------------------------------


def _cpu(j):
    return interop.limbs_from_numpy(np.asarray(j), "cpu")


def test_eq_table_matches_jax():
    rng = random.Random(5)
    point = [rng.randrange(JG.p) for _ in range(5)]
    np.testing.assert_array_equal(
        interop.limbs_to_numpy(gdev.eq_table(GOLDILOCKS, point, "cpu")), np.asarray(jgdev.eq_table(JG, point))
    )
    assert dev.decode_ints(GOLDILOCKS, gdev.eq_table(GOLDILOCKS, [], "cpu")) == [1]


def test_evaluate_device_matches_jax():
    rng = random.Random(3)
    jc = jcircuit.Circuit(random_circuit(rng, 4, 16, 12, jcircuit.Gate), n_inputs=12)
    inputs = [rng.randrange(JG.p) for _ in range(12)]
    want = jgdev.evaluate_device(jc, JG, inputs)
    c = interop.circuit_from_jax(jc)
    got = gdev.evaluate_device(c, GOLDILOCKS, inputs, "cpu")
    from_tensor = gdev.evaluate_device(c, GOLDILOCKS, dev.encode_ints(GOLDILOCKS, inputs, device="cpu"))
    for w, g, t in zip(want, got, from_tensor):
        np.testing.assert_array_equal(interop.limbs_to_numpy(g), np.asarray(w))
        assert torch.equal(g, t)
    assert [dev.decode_ints(GOLDILOCKS, g) for g in got] == jc.evaluate(JG, inputs)


def _low_opt(fn, static, *args):
    """A jitted zk_tpu function fn(*static, *args), compiled at XLA's lowest
    backend optimization level: the same integers for about half the
    compile CPU (the jit cache that zk_tpu's own tests use is left alone)."""
    return fn.lower(*static, *args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def test_phase_tables_match_both_jax_strategies():
    """The port's one scatter strategy (int64 index_add_ + one renorm)
    against the reference's scatter AND gather-plan variants."""
    jc = high_fanin()
    assert jc.gather_plan(0, "left").shape[0] > jgdev._GATHER_FANIN_MAX
    c = interop.circuit_from_jax(jc)
    rng = random.Random(19)
    inputs = [rng.randrange(JG.p) for _ in range(64)]
    jlev = jgdev.evaluate_device(jc, JG, inputs)
    r = [rng.randrange(JG.p) for _ in range(7)]
    u = [rng.randrange(JG.p) for _ in range(6)]
    # eq_table and mle_eval_points, through the kernels they dispatch to
    j_eq_r = _low_opt(jgdev._eq_expand, (JG, 7), jgdev._mont_rs(JG, r))
    j_eq_u = _low_opt(jgdev._eq_expand, (JG, 6), jgdev._mont_rs(JG, u))
    j_w = jlev[1]
    j_wu = _low_opt(jgdev._eval_points_kernel, (JG, 6), j_w, jgdev._mont_rs(JG, u).reshape(1, 6, JG.n_limbs))
    assert dev.decode_ints(GOLDILOCKS, _cpu(j_eq_r)) == dev.decode_ints(GOLDILOCKS, gdev.eq_table(GOLDILOCKS, r, "cpu"))
    assert dev.decode_ints(GOLDILOCKS, _cpu(j_wu)) == [mle_eval_host(GOLDILOCKS, dev.decode_ints(GOLDILOCKS, _cpu(j_w)), u)]
    left, right, is_add = jc.device_wiring(0)
    want1 = [
        _low_opt(jgdev._phase1_tables, (JG, 64), j_eq_r, j_w, left, right, is_add),
        _low_opt(jgdev._phase1_tables_g, (JG, 64), j_eq_r, j_w, right, is_add, jc.device_gather_plan(0, "left")),
    ]
    want2 = [
        _low_opt(jgdev._phase2_tables, (JG, 64), j_eq_r, j_eq_u, j_w, j_wu, left, right, is_add),
        _low_opt(jgdev._phase2_tables_g, (JG, 64), j_eq_r, j_eq_u, j_w, j_wu, left, is_add,
                 jc.device_gather_plan(0, "right")),
    ]
    w = _cpu(j_w)
    got1 = gdev.phase1_tables(GOLDILOCKS, c, 0, _cpu(j_eq_r), w)
    got2 = gdev.phase2_tables(GOLDILOCKS, c, 0, _cpu(j_eq_r), _cpu(j_eq_u), w, _cpu(j_wu))
    for want, got in ((want1, got1), (want2, got2)):
        for variant in want:
            for wt, gt in zip(variant, got):
                np.testing.assert_array_equal(interop.limbs_to_numpy(gt), np.asarray(wt))


def test_line_restriction_evals_matches_jax():
    rng = random.Random(23)
    data = np.asarray(jdev.encode_ints(JG, [rng.randrange(JG.p) for _ in range(32)]))
    b = [rng.randrange(JG.p) for _ in range(5)]
    c = [rng.randrange(JG.p) for _ in range(5)]
    want = jgdev.line_restriction_evals(JG, jnp.asarray(data), b, c)
    assert gdev.line_restriction_evals(GOLDILOCKS, _cpu(data), b, c) == want
    vals = dev.decode_ints(GOLDILOCKS, _cpu(data))
    assert want[0] == mle_eval_host(GOLDILOCKS, vals, b) and want[1] == mle_eval_host(GOLDILOCKS, vals, c)


@pytest.mark.parametrize("field", list(TF))
def test_wiring_eval_matches_jax_host(field):
    jf, field = JF[field], TF[field]
    rng = random.Random(11)
    jc = jcircuit.Circuit(random_circuit(rng, 2, 8, 8, jcircuit.Gate), n_inputs=8)
    c = interop.circuit_from_jax(jc)
    r = [rng.randrange(field.p) for _ in range(c.layer_k(0))]
    b = [rng.randrange(field.p) for _ in range(c.layer_k(1))]
    cc = [rng.randrange(field.p) for _ in range(c.layer_k(1))]
    want = tuple(jgkr._wiring_eval_host(jf, jc, 0, op, r + b + cc) for op in ("add", "mul"))
    assert gdev.wiring_eval(field, c, 0, r, b, cc, "cpu") == want
    assert tuple(_wiring_eval_host(field, c, 0, op, r + b + cc) for op in ("add", "mul")) == want


# --------------------------------------------------------------------------
# GKR end to end
# --------------------------------------------------------------------------

PROVERS = {
    "per_phase": lambda f, c, x: GKRProver.prove(f, c, x, device="cpu")[0],
    "per_phase_device_transcript": lambda f, c, x: GKRProver.prove(f, c, x, tail_size=1, device_transcript=True, device="cpu")[0],
    "chain": lambda f, c, x: GKRProver.prove(f, c, x, device_transcript=True, device="cpu")[0],
    "dense": lambda f, c, x: GKRProver.prove_dense(f, c, x, device="cpu")[0],
}


@pytest.mark.parametrize("prover", list(PROVERS))
def test_d3w8_proof_equals_golden(prover):
    c, inputs = d3w8(BLS12_381_FR)
    proof = PROVERS[prover](BLS12_381_FR, c, inputs)
    with open(os.path.join(GOLDENS, "gkr_d3w8_prove.bin"), "rb") as f:
        assert gkr_proof_to_bytes(BLS12_381_FR, proof) == f.read()


def test_chain_matches_per_phase_above_the_tail():
    """A 2^12-wire Goldilocks layer: the phase sumchecks run their device
    rounds (fold + round_sums_terms) above the 2048-entry host tail."""
    rng = random.Random(29)
    c = Circuit(random_circuit(rng, 2, 1 << 12, 1 << 12), n_inputs=1 << 12)
    inputs = [rng.randrange(GOLDILOCKS.p) for _ in range(1 << 12)]
    chain, _ = prove_chain(GOLDILOCKS, c, inputs, "cpu")
    synced, _ = GKRProver.prove(GOLDILOCKS, c, inputs, device="cpu")
    assert chain == synced
    assert GKRVerifier.verify(GOLDILOCKS, c, inputs, chain, device="cpu")


@pytest.mark.parametrize("field", list(TF))
def test_prove_equals_prove_dense(field):
    field = TF[field]
    rng = random.Random(31)
    c = Circuit(random_circuit(rng, 3, 8, 8), n_inputs=8)
    inputs = [rng.randrange(field.p) for _ in range(8)]
    fast, levels = GKRProver.prove(field, c, inputs, device="cpu")
    dense, host_levels = GKRProver.prove_dense(field, c, inputs, device="cpu")
    assert fast == dense
    assert [dev.decode_ints(field, lv) for lv in levels] == host_levels
    assert GKRVerifier.verify(field, c, inputs, fast, device="cpu")


def test_d3w8_matches_jax_prove_goldilocks():
    """One direct comparison with zk_tpu's own GKR prover (Goldilocks)."""
    rng = random.Random(7)
    jc = jcircuit.Circuit(random_circuit(rng, 3, 8, 8, jcircuit.Gate), n_inputs=8)
    inputs = [rng.randrange(JG.p) for _ in range(8)]
    want, _ = jgkr.GKRProver.prove(JG, jc, inputs, device_transcript=False)
    got, _ = GKRProver.prove(GOLDILOCKS, interop.circuit_from_jax(jc), inputs, device="cpu")
    assert gkr_proof_to_bytes(GOLDILOCKS, got) == jgkr.gkr_proof_to_bytes(JG, want)


def test_serde_roundtrip_and_device_inputs():
    c, inputs = d3w8(BLS12_381_FR)
    proof, _ = GKRProver.prove(BLS12_381_FR, c, inputs, device="cpu")
    data = gkr_proof_to_bytes(BLS12_381_FR, proof)
    back = gkr_proof_from_bytes(BLS12_381_FR, data)
    assert back == proof
    with pytest.raises(ValueError, match="trailing"):
        gkr_proof_from_bytes(BLS12_381_FR, data + b"\x00")
    dev_inputs = dev.encode_ints(BLS12_381_FR, inputs, device="cpu")
    assert GKRProver.prove(BLS12_381_FR, c, dev_inputs)[0] == proof
    assert GKRVerifier.verify(BLS12_381_FR, c, dev_inputs, back)
    assert GKRVerifier.verify(BLS12_381_FR, c, inputs, back, device="cpu")


def _two_layer_proof():
    c = two_layer()
    return c, GKRProver.prove(BLS12_381_FR, c, [2, 3, 4, 5], device="cpu")[0]


def test_verifier_accepts_honest_proof():
    c, proof = _two_layer_proof()
    assert proof.outputs == [(2 + 3) * (4 * 5)]
    assert GKRVerifier.verify(BLS12_381_FR, c, [2, 3, 4, 5], proof, device="cpu")


def test_verifier_rejects_tampered_output():
    c, proof = _two_layer_proof()
    bad = GKRProof(outputs=[proof.outputs[0] + 1], layer_proofs=proof.layer_proofs)
    with pytest.raises((GKRError, SumcheckError)):
        GKRVerifier.verify(BLS12_381_FR, c, [2, 3, 4, 5], bad, device="cpu")


def test_verifier_rejects_tampered_w_b():
    c, proof = _two_layer_proof()
    lp = proof.layer_proofs[0]
    lp_bad = type(lp)(sumcheck=lp.sumcheck, w_b=lp.w_b + 1, w_c=lp.w_c, q_evals=lp.q_evals)
    bad = GKRProof(outputs=proof.outputs, layer_proofs=[lp_bad] + proof.layer_proofs[1:])
    with pytest.raises((GKRError, SumcheckError)):
        GKRVerifier.verify(BLS12_381_FR, c, [2, 3, 4, 5], bad, device="cpu")


def test_verifier_rejects_wrong_inputs():
    c, proof = _two_layer_proof()
    assert GKRVerifier.verify(BLS12_381_FR, c, [2, 3, 4, 6], proof, device="cpu") is False


def test_non_canonical_output_bytes_rejected_by_both_packages():
    """A Goldilocks proof whose output y travels as the 8 bytes of y + p:
    both verifiers absorb the bytes received, so the challenges move and
    both raise SumcheckError; bytes -> proof -> bytes is the identity in
    both packages (host ints only)."""
    from zk_tpu.sumcheck import SumcheckError as JSumcheckError

    c = two_layer()
    jc = jcircuit.Circuit([[jcircuit.Gate(g.op, g.left, g.right) for g in layer] for layer in c.layers], 4)
    inputs = [2, 3, 4, 5]
    proof, _ = GKRProver.prove(GOLDILOCKS, c, inputs, device="cpu")
    data = gkr_proof_to_bytes(GOLDILOCKS, proof)
    y = proof.outputs[0]
    assert data[4:12] == y.to_bytes(8, "big") and y + GOLDILOCKS.p < 1 << 64
    bad = data[:4] + (y + GOLDILOCKS.p).to_bytes(8, "big") + data[12:]

    port = gkr_proof_from_bytes(GOLDILOCKS, bad)
    ref = jgkr.gkr_proof_from_bytes(JG, bad)
    assert port.outputs == ref.outputs == [y]
    assert gkr_proof_to_bytes(GOLDILOCKS, port) == jgkr.gkr_proof_to_bytes(JG, ref) == bad
    with pytest.raises(JSumcheckError):
        jgkr.GKRVerifier.verify(JG, jc, inputs, ref)
    with pytest.raises(SumcheckError):
        GKRVerifier.verify(GOLDILOCKS, c, inputs, port, device="cpu")
    good = gkr_proof_from_bytes(GOLDILOCKS, data)
    assert good == port and gkr_proof_to_bytes(GOLDILOCKS, good) == data
    assert GKRVerifier.verify(GOLDILOCKS, c, inputs, good, device="cpu")
    assert jgkr.GKRVerifier.verify(JG, jc, inputs, jgkr.gkr_proof_from_bytes(JG, data))


def test_verifier_device_checks_on_a_wide_circuit():
    """Above 256 gates and 4096 outputs or inputs the verifier evaluates
    the output table, the wiring predicates and the inputs on the device;
    a wrong w_b is caught there too."""
    rng = random.Random(37)
    c = Circuit(random_circuit(rng, 1, 1 << 14, 5000), n_inputs=5000)
    inputs = [rng.randrange(GOLDILOCKS.p) for _ in range(5000)]
    proof, _ = GKRProver.prove(GOLDILOCKS, c, inputs, device="cpu")
    assert len(proof.outputs) == 1 << 13
    assert GKRVerifier.verify(GOLDILOCKS, c, inputs, proof, device="cpu")
    lp = proof.layer_proofs[0]
    lp_bad = type(lp)(sumcheck=lp.sumcheck, w_b=(lp.w_b + 1) % GOLDILOCKS.p, w_c=lp.w_c, q_evals=lp.q_evals)
    with pytest.raises(GKRError):
        GKRVerifier.verify(GOLDILOCKS, c, inputs, GKRProof(outputs=proof.outputs, layer_proofs=[lp_bad]), device="cpu")


def test_circuit_validation_and_evaluation():
    with pytest.raises(ValueError):
        Circuit([[Gate("add", 0, 5)]], n_inputs=2)
    with pytest.raises(ValueError):
        Gate("xor", 0, 1)
    with pytest.raises(ValueError):
        Circuit.from_arrays([(np.array([0]), np.array([2]), np.array([True]))], n_inputs=2)
    c = two_layer()
    assert c.evaluate(GOLDILOCKS, [2, 3, 4, 5]) == [[100], [5, 20], [2, 3, 4, 5]]
    jc = jcircuit.Circuit([[jcircuit.Gate("mul", 0, 1)], [jcircuit.Gate("add", 0, 1), jcircuit.Gate("mul", 2, 3)]], 4)
    back = interop.circuit_from_jax(jc)
    assert [list(layer) for layer in back.layers] == [list(layer) for layer in c.layers]
