"""The plain reference agrees with the program's CPU tier on small
statements, byte for byte, and its verifiers decide as they must.  (The
tests may import the program; the reference may not.)"""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import inputs
from benchmark.reference import field as F
from benchmark.reference import sumcheck as RS
from benchmark.reference.keccak import Keccak256, Transcript


def _tables(seed: int, count: int, n: int) -> list[torch.Tensor]:
    return list(inputs.random_elements(inputs.generator(seed, "cpu"), count, 1 << n))


def test_keccak_known_answers():
    assert Keccak256().digest().hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    from zk_tpu_torch.transcript.keccak import keccak256

    for n in (1, 135, 136, 137, 1000):
        data = os.urandom(n)
        k = Keccak256()
        k.update(data[: n // 3])
        k.update(data[n // 3 :])
        assert k.digest() == keccak256(data)


def test_field_arithmetic_against_python_ints():
    xs = [3, F.P - 1, 2**200 + 12345, 0, F.P // 3]
    ys = [F.P - 2, F.P - 1, 7, 5, 2**254 % F.P]
    a, b = F.columns([F.to_mont(x) for x in xs], "cpu"), F.columns([F.to_mont(y) for y in ys], "cpu")
    dec = lambda t: [F.from_mont(v) for v in F.ints(t)]  # noqa: E731
    assert dec(F.mul(a, b)) == [x * y % F.P for x, y in zip(xs, ys)]
    assert dec(F.add(a, b)) == [(x + y) % F.P for x, y in zip(xs, ys)]
    assert dec(F.sub(a, b)) == [(x - y) % F.P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n,k", [(12, 1), (10, 2), (6, 3)])
def test_sumcheck_reference_equals_the_program(n, k):
    from zk_tpu_torch import MLE, ProductPoly, SumcheckProver, proof_to_bytes
    from zk_tpu_torch.fields import BLS12_381_FR as FR

    tables = _tables(100 + n, k, n)
    claim = RS.claimed_sum(tables)
    poly = ProductPoly([MLE(FR, n, t) for t in tables])
    proof, challenges = SumcheckProver.prove_partial(poly, claim, max_var_degree=k)
    rps, chs, finals = RS.prove(tables, k, claim, Transcript())
    assert RS.proof_bytes(claim, rps) == proof_to_bytes(FR, proof)
    assert chs == challenges
    assert finals == [m.evaluate(challenges) for m in poly.polynomials] == [F.evaluate(t, chs) for t in tables]
    ok, _, final = RS.verify_rounds(claim, rps, Transcript())
    product = 1
    for v in finals:
        product = product * v % F.P
    assert ok and final == product
    bad = [list(r) for r in rps]
    bad[n // 2][0] = (bad[n // 2][0] + 1) % F.P
    assert not RS.verify_rounds(claim, bad, Transcript())[0]



def _matmul(n: int, seed: int):
    """The benchmark's matrix-product circuit for the program and the
    reference, and one statement's inputs."""
    from zk_tpu_torch import Circuit

    from benchmark.reference import gkr as RG

    wiring = RG.matmul(n)
    circuit = Circuit.from_arrays([tuple(t.numpy() for t in layer) for layer in wiring.layers], wiring.n_inputs)
    return wiring, circuit, inputs.random_elements(inputs.generator(seed, "cpu"), 1, wiring.n_inputs)[0]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_gkr_reference_equals_the_program(n):
    from zk_tpu_torch import GKRProver, GKRVerifier
    from zk_tpu_torch.fields import BLS12_381_FR as FR
    from zk_tpu_torch.gkr import GKRError, gkr_proof_from_bytes, gkr_proof_to_bytes
    from zk_tpu_torch.sumcheck import SumcheckError

    from benchmark.jobs import gkr as J
    from benchmark.reference import gkr as RG

    wiring, circuit, x = _matmul(n, 200 + n)
    data, out_bytes = RG.prove(wiring, x)
    assert data == gkr_proof_to_bytes(FR, GKRProver.prove(FR, circuit, x)[0])
    ints = [F.from_mont(v) for v in F.ints(x)]
    dense = GKRProver.prove_dense(FR, circuit, ints, device="cpu")[0]
    assert data == gkr_proof_to_bytes(FR, dense)

    a, b = ints[: n * n], ints[n * n :]
    c = [sum(a[i * n + k] * b[k * n + j] for k in range(n)) % F.P for i in range(n) for j in range(n)]
    assert out_bytes == b"".join(v.to_bytes(F.N_BYTES, "big") for v in c)

    assert RG.verify(wiring, x, data)
    bad = J.tampered(data)
    assert bad != data and not RG.verify(wiring, x, bad)
    with pytest.raises((GKRError, SumcheckError)):
        GKRVerifier.verify(FR, circuit, x, gkr_proof_from_bytes(FR, bad))


def test_gkr_yardstick_counts_the_n2_circuit_by_hand():
    from benchmark import yardstick as Y

    layers = Y.matmul_layers(2)
    assert layers == [(4, 0, 2, 3), (8, 8, 3, 3)]  # 4 sums over 8 products over 8 inputs
    # per layer: witness, eq(r) 2^k_out - 2, eq(u) 2^3 - 2, 2 G for the phase
    # tables, phase 1 3 x 7 + 3 x 6, phase 2 6 x 7 + 3 x 6 + 3 x 3, the line
    # 8 x 1 + 4 x 2 + 2 x 3
    add = 0 + 2 + 6 + 8 + (21 + 18) + (42 + 18 + 9) + 22
    mul = 8 + 6 + 6 + 16 + (21 + 18) + (42 + 18 + 9) + 22
    assert Y.gkr_needed_mults(layers) == (4 - 1) + add + mul == 315
    elem = 64  # bytes of an element: 16 limbs, 4 bytes each
    assert Y.gkr_bytes(layers, 16) == elem * (4 + 8 + 8) + elem * (4 + 5 * 8) + 8 * 4 + elem * (8 + 5 * 8) + 8 * 8


def test_mesh_reference_equals_the_whole_table_and_the_sharded_program():
    """At n = 12 over 4 gloo ranks: the ranks' reference (reference/
    sumcheck_mesh.py) gives the bytes, challenges and finals of
    ``sumcheck.prove`` on the whole tables, rebuilt here from the ranks'
    seeds in the sharded layout, and ShardedSumcheckProver gives the same
    bytes, challenges and oracle values."""
    from benchmark import harness
    from benchmark.tests.conftest import small_cell

    cell = small_cell("sumcheck-bls381-n29-mesh4-prod2")
    kind = harness.load_module("jobs", cell.config["job"])
    seed, ranks, k, pool = 2**33 + 5, cell.config["ranks"], cell.traffic["factors"], cell.traffic["pool"]
    state = kind.setup(cell.config, cell.traffic, seed, "cpu")
    W = 1 << (cell.config["n_vars"] - 2)
    shards = [inputs.random_elements(inputs.generator(seed * ranks + d, "cpu"), pool * k, W).reshape(pool, k, 16, W)
              for d in range(ranks)]
    whole = torch.stack(shards, dim=-1).reshape(pool, k, 16, W * ranks)  # entry w * R + d from rank d
    for i in range(pool):
        claim = RS.claimed_sum(list(whole[i]))
        rps, chs, finals = RS.prove(list(whole[i]), cell.traffic["degree"], claim, Transcript())
        ref = state.mesh.call("replay", i, None)[0]
        assert state.claims[i] == claim
        assert ref == {"bytes": RS.proof_bytes(claim, rps), "challenges": chs, "oracle": finals}
        got = kind.job(state, i, harness.Clock(traced=False))
        assert (got["bytes"], got["challenges"], got["oracle"], got["accepted"]) == (ref["bytes"], chs, finals, True)
    state.mesh.stop()


def test_mesh_roofline_least_time_by_hand():
    """mesh_prove_roofline_pct's least time: one rank's 2^3-entry shards at
    n = 5 over 4 ranks, product-bound."""
    from benchmark import harness
    from benchmark import trace as T
    from benchmark import yardstick as Y
    from benchmark.tests.conftest import small_cell

    # degree 2, 2 factors: per pair 1 product at 3 points and 2 folds (none
    # after the last round): 4 pairs 12 + 8, 2 pairs 6 + 4, 1 pair 3
    assert Y.sumcheck_needed_mults(3, 2, 2) == 33
    least = max(33 * 4 * 8 * 8 / (64 * 132 * 1.98e9), 2 * 16 * 4 * 8 / 3.35e12)
    assert least == 33 * 256 / Y.IMAD_PER_S == Y.sumcheck_least_seconds(3, 2, 2, 16)
    cell = small_cell("sumcheck-bls381-n29-mesh4-prod2")
    cell.config["n_vars"] = 5
    trace = T.Trace((0, 100), [(0, 10, "fold")], [(0, 10)], {"prove": [(0, 50)], "verify": [(50, 100)]}, [])
    run = harness.Run(cell, 0.0, (0.0, 1.0), [], None, trace)
    assert harness.load_module("metrics", "mesh_prove_roofline_pct").read(run) == 100.0 * least / 10e-9
