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

