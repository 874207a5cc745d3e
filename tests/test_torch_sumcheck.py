"""The port's sumcheck prover and verifier against zk_tpu's: the same
proof bytes, challenges and accept/reject decisions (exact).

The same seeded tables go to both packages (through interop); the JAX side
runs its own CPU tiers (host ints, and its jnp graphs with its device
transcript on Goldilocks), which its own tests hold byte-identical to each
other and to its Pallas tiers.  The frozen goldens in tests/goldens/ are
rebuilt through the port.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from zk_tpu import fields as jfields
from zk_tpu import sumcheck as jsc
from zk_tpu.poly import MLE as JMLE
from zk_tpu.poly import CoeffMultilinearPolynomial
from zk_tpu.poly import ProductPoly as JProductPoly
from zk_tpu.poly.univariate import UnivariatePolynomial as JUni
from zk_tpu_torch import (
    MLE,
    ProductPoly,
    SumcheckError,
    SumcheckProof,
    SumcheckProver,
    SumcheckVerifier,
    interop,
    proof_from_bytes,
    proof_to_bytes,
)
from zk_tpu_torch.fields import BLS12_381_FR, GOLDILOCKS
from zk_tpu_torch.poly.univariate import UnivariatePolynomial
from torch_helpers import once_per_session

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FR = BLS12_381_FR
JFR = jfields.BLS12_381_FR  # each package gets its own field object
JF = {f.name: f for f in (jfields.GOLDILOCKS, jfields.BLS12_381_FR)}


def _golden(name: str) -> bytes:
    with open(os.path.join(GOLDENS, name), "rb") as f:
        return f.read()


# --------------------------------------------------------------------------
# frozen goldens, rebuilt through the port
# --------------------------------------------------------------------------


def _p_2ab_3bc(device="cpu"):
    evals = CoeffMultilinearPolynomial.new(
        JFR, 3, [(2, [True, True, False]), (3, [False, True, True])]
    ).to_evaluation_form()
    return ProductPoly([MLE.new(FR, 3, evals, device=device)])


def _p_deg2(device="cpu"):
    p1 = CoeffMultilinearPolynomial.new(
        JFR, 2, [(2, [True, False]), (0, [False, True]), (3, [False, False])]
    ).to_evaluation_form()
    p2 = CoeffMultilinearPolynomial.new(JFR, 2, [(1, [True, True])]).to_evaluation_form()
    return ProductPoly([MLE.new(FR, 2, p1, device=device), MLE.new(FR, 2, p2, device=device)])


def test_golden_2ab3bc_prove():
    proof = SumcheckProver.prove(_p_2ab_3bc(), 10, max_var_degree=1)
    assert proof_to_bytes(FR, proof) == _golden("sumcheck_2ab3bc_prove.bin")
    assert SumcheckVerifier.verify(_p_2ab_3bc(), proof)


def test_golden_2ab3bc_partial_and_challenges():
    proof, challenges = SumcheckProver.prove_partial(_p_2ab_3bc(), 10, max_var_degree=1)
    assert proof_to_bytes(FR, proof) == _golden("sumcheck_2ab3bc_partial.bin")
    with open(os.path.join(GOLDENS, "challenges.json")) as f:
        assert [hex(c) for c in challenges] == json.load(f)["partial_challenges"]
    sub = SumcheckVerifier.verify_partial(FR, proof)
    assert sub.challenges == challenges
    assert _p_2ab_3bc().evaluate(sub.challenges) == sub.sum


def test_golden_deg2_prove():
    poly = _p_deg2()
    proof = SumcheckProver.prove(poly, 5, max_var_degree=2)
    assert proof_to_bytes(FR, proof) == _golden("sumcheck_deg2_prove.bin")
    assert SumcheckVerifier.verify(poly, proof)


def test_golden_wrong_sum_rejected_as_jax_rejects_it():
    proof = SumcheckProver.prove(_p_2ab_3bc(), 12, max_var_degree=1)
    data = proof_to_bytes(FR, proof)
    assert data == _golden("sumcheck_wrong_sum_prove.bin")
    with pytest.raises(SumcheckError):
        SumcheckVerifier.verify(_p_2ab_3bc(), proof)
    jpoly = JProductPoly([JMLE.new(JFR, 3, _p_2ab_3bc().polynomials[0].evaluation_ints())])
    with pytest.raises(jsc.SumcheckError):
        jsc.SumcheckVerifier.verify(jpoly, jsc.proof_from_bytes(JFR, data))


@pytest.mark.cuda
def test_cuda_device_transcript_rounds_give_the_goldens():
    """On a card, every round on the device (tail_size=1: transcript_round
    and the table kernels, degree 1 and 2): the frozen golden bytes and
    challenges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev1 = dict(device_transcript=True, tail_size=1)
    proof = SumcheckProver.prove(_p_2ab_3bc("cuda"), 10, max_var_degree=1, **dev1)
    assert proof_to_bytes(FR, proof) == _golden("sumcheck_2ab3bc_prove.bin")
    proof, challenges = SumcheckProver.prove_partial(_p_2ab_3bc("cuda"), 10, max_var_degree=1, **dev1)
    assert proof_to_bytes(FR, proof) == _golden("sumcheck_2ab3bc_partial.bin")
    with open(os.path.join(GOLDENS, "challenges.json")) as f:
        assert [hex(c) for c in challenges] == json.load(f)["partial_challenges"]
    proof = SumcheckProver.prove(_p_deg2("cuda"), 5, max_var_degree=2, **dev1)
    assert proof_to_bytes(FR, proof) == _golden("sumcheck_deg2_prove.bin")


def test_golden_proof_bytes_roundtrip():
    data = _golden("sumcheck_2ab3bc_prove.bin")
    assert proof_to_bytes(FR, proof_from_bytes(FR, data)) == data
    with pytest.raises(ValueError):
        proof_from_bytes(FR, data + b"\x00")


def test_round_poly_count_check():
    proof = SumcheckProver.prove(_p_2ab_3bc(), 10, max_var_degree=1)
    with pytest.raises(SumcheckError):
        SumcheckVerifier.verify(_p_2ab_3bc(), SumcheckProof(proof.sum, proof.round_polys[:-1]))


# --------------------------------------------------------------------------
# the slice as a whole, against zk_tpu on the same tables
# --------------------------------------------------------------------------

SLICE = {"Goldilocks": (GOLDILOCKS, 13), "BLS12-381-Fr": (FR, 12)}


def _table(field, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(field.n_limbs, 1 << n), dtype=np.uint32)
    top = (field.p >> (16 * (field.n_limbs - 1))).bit_length() - 1
    a[field.n_limbs - 1] &= (1 << top) - 1
    return a


def _jax_proofs():
    import jax.numpy as jnp

    out = {}
    for name, (_, n) in SLICE.items():
        field = JF[name]
        jpoly = JProductPoly([JMLE(field, n, jnp.asarray(_table(field, n, 99)))])
        total = sum(jpoly.polynomials[0].evaluation_ints()) % field.p
        # zk_tpu's host-int tier: the same bytes as its jnp tier (zk_tpu's own
        # tests), without compiling its BLS12-381 graphs (~30 s of CPU)
        host = dict(max_var_degree=1, tail_size=1 << 30, device_transcript=False)
        part, chs = jsc.SumcheckProver.prove_partial(jpoly, total, **host)
        full = jsc.SumcheckProver.prove(jpoly, total, **host)
        out[name] = dict(total=total, partial=jsc.proof_to_bytes(field, part).hex(), challenges=chs,
                         full=jsc.proof_to_bytes(field, full).hex())
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """zk_tpu's proofs on each slice table (computed once per session)."""
    runs = once_per_session(tmp_path_factory, "jax_sumcheck_runs", _jax_proofs)
    for name, (_, n) in SLICE.items():
        run = runs[name]
        run["data"] = _table(JF[name], n, 99)
        run["partial"], run["full"] = bytes.fromhex(run["partial"]), bytes.fromhex(run["full"])
    return runs


def _port_poly(name, run):
    field, n = SLICE[name]
    return ProductPoly([interop.mle_from_jax(field, n, run["data"], "cpu")])


TIERS = {
    "synced": dict(device_transcript=False),
    "synced_no_tail": dict(device_transcript=False, tail_size=1),
    "device_transcript": dict(device_transcript=True),
    "device_transcript_no_tail": dict(device_transcript=True, tail_size=1),
    "host": dict(tail_size=1 << 30, device_transcript=False),
}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("name", list(SLICE))
def test_prove_partial_matches_jax(jax_runs, name, tier):
    run = jax_runs[name]
    field = SLICE[name][0]
    proof, chs = SumcheckProver.prove_partial(_port_poly(name, run), run["total"], max_var_degree=1, **TIERS[tier])
    assert proof_to_bytes(field, proof) == run["partial"]
    assert chs == run["challenges"]


@pytest.mark.parametrize("name", list(SLICE))
def test_prove_and_verify_match_jax(jax_runs, name):
    run = jax_runs[name]
    field = SLICE[name][0]
    poly = _port_poly(name, run)
    proof = SumcheckProver.prove(poly, run["total"], max_var_degree=1)
    assert proof_to_bytes(field, proof) == run["full"]
    assert SumcheckVerifier.verify(poly, proof_from_bytes(field, run["full"]))


@pytest.mark.parametrize("name", list(SLICE))
def test_verify_partial_and_oracle_check(jax_runs, name):
    run = jax_runs[name]
    field = SLICE[name][0]
    sub = SumcheckVerifier.verify_partial(field, proof_from_bytes(field, run["partial"]))
    assert sub.challenges == run["challenges"]
    assert _port_poly(name, run).evaluate(sub.challenges) == sub.sum


def test_tampered_round_poly_rejected_by_both(jax_runs):
    run = jax_runs["Goldilocks"]
    field = GOLDILOCKS
    proof = proof_from_bytes(field, run["partial"])
    proof.round_polys[3][0] = (proof.round_polys[3][0] + 1) % field.p
    with pytest.raises(SumcheckError):
        SumcheckVerifier.verify_partial(field, proof)
    jf = JF[field.name]
    with pytest.raises(jsc.SumcheckError):
        jsc.SumcheckVerifier.verify_partial(jf, jsc.proof_from_bytes(jf, proof_to_bytes(field, proof)))


def test_device_transcript_matches_jax_device_transcript():
    """Both packages' device-resident sponges on the same Goldilocks table."""
    import jax.numpy as jnp

    field, n = GOLDILOCKS, 13
    jf = JF[field.name]
    data = _table(field, n, 7)
    total = sum(MLE(field, n, interop.limbs_from_numpy(data, "cpu")).evaluation_ints()) % field.p
    jpoly = JProductPoly([JMLE(jf, n, jnp.asarray(data))])
    jproof, jchs = jsc.SumcheckProver.prove_partial(jpoly, total, max_var_degree=1, device_transcript=True)
    poly = ProductPoly([interop.mle_from_jax(field, n, data, "cpu")])
    proof, chs = SumcheckProver.prove_partial(poly, total, max_var_degree=1, device_transcript=True)
    assert proof_to_bytes(field, proof) == jsc.proof_to_bytes(jf, jproof)
    assert chs == jchs


def test_general_rounds_above_tail_equal_host_tier():
    """Degree-2 rounds above the tail run the fold and round-sums kernels'
    tier and give the host tier's proof."""
    field = GOLDILOCKS
    a = MLE.new(field, 4, list(range(16)), device="cpu")
    total = sum(x * x for x in range(16))
    host, _ = SumcheckProver.prove_partial(ProductPoly([a, a]), total, max_var_degree=2)
    for dt in (False, True):
        proof, _ = SumcheckProver.prove_partial(ProductPoly([a, a]), total, max_var_degree=2, tail_size=4, device_transcript=dt)
        assert proof == host
    assert len(host.round_polys) == 4
    assert torch.equal(a.data, MLE.new(field, 4, list(range(16)), device="cpu").data)  # tables untouched


@pytest.mark.parametrize("ys", [[5], [3, 9], [1, 4, 9, 16], [7, 0, 2**70, 11]])
def test_univariate_interpolate_matches_jax(ys):
    want = JUni.interpolate(JFR, ys)
    got = UnivariatePolynomial.interpolate(FR, ys)
    assert got.coefficients == want.coefficients
    for x in (0, 1, 2, 12345, FR.p - 1):
        assert got.evaluate(x) == want.evaluate(x)


def _canonical_limbs(field, rng, shape):
    """Random canonical field elements, 0 and p - 1 among them, as int32
    limbs with the limb axis second: shape (rows, L, cols)."""
    rows, cols = shape
    vals = [rng.randrange(field.p) for _ in range(rows * cols)]
    vals[0], vals[-1] = 0, field.p - 1
    limbs = [[(v >> (16 * j)) & 0xFFFF for j in range(field.n_limbs)] for v in vals]
    return vals, np.array(limbs, dtype=np.int32).reshape(rows, cols, field.n_limbs).transpose(0, 2, 1)


def test_record_decode_gives_host_ints():
    """The round record's one-pass decode of its (rounds, L, D+1) sums and
    (rounds, L, 1) challenges gives the ints of per-element host_ints, for
    BLS12-381 Fr and Goldilocks at D+1 = 2, 3, 4 and 1 or 24 rounds (one
    case for all twelve: the tier-1 test count is a setting, ROADMAP Open
    items)."""
    from zk_tpu_torch.fields import device as dev
    from zk_tpu_torch.sumcheck.record import decode_rows

    for field in (FR, GOLDILOCKS):
        for points in (2, 3, 4):
            for rounds in (1, 24):
                rng = random.Random(points * 100 + rounds)
                vals, sums = _canonical_limbs(field, rng, (rounds, points))
                chs_vals, chs = _canonical_limbs(field, rng, (rounds, 1))
                polys, challenges = decode_rows(field, sums, chs)
                assert polys == [dev.host_ints(field, torch.from_numpy(s), mont=False) for s in sums]
                assert challenges == [dev.host_ints(field, torch.from_numpy(c), mont=False)[0] for c in chs]
                assert polys == [vals[r * points : (r + 1) * points] for r in range(rounds)]
                assert challenges == chs_vals
