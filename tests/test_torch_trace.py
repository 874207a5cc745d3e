"""The port's spans and its one device -> host read (zk_tpu_torch.utils.stat):
a shared no-op without a profiler; under one, each layer of a prove, a
verify and a GKR prove opens its span, and every read is one zk.sync."""

import random

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zk_tpu_torch import (
    MLE,
    GKRProver,
    ProductPoly,
    SumcheckProver,
    SumcheckVerifier,
    proof_from_bytes,
    proof_to_bytes,
)
from zk_tpu_torch.fields import BLS12_381_FR as FR
from zk_tpu_torch.fields import GOLDILOCKS
from zk_tpu_torch.gkr.circuit import Circuit, Gate
from zk_tpu_torch.utils import span, to_host

torch.set_num_threads(1)

N, TAIL = 10, 128  # three device rounds (2^10 entries down to 128), then the host tail


@pytest.fixture
def statement():
    vals = [random.Random(N).randrange(FR.p) for _ in range(1 << N)]
    return ProductPoly([MLE.new(FR, N, vals, device="cpu")]), sum(vals) % FR.p


def prove(poly, claim):
    return SumcheckProver.prove_partial(poly, claim, tail_size=TAIL, device_transcript=True)


def ranges(fn):
    """fn() under a CPU profile: (its result, the zk.* ranges as (name, start,
    end), by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith("zk.")]
    return out, sorted(evs, key=lambda r: (r[1], -r[2]))


def names_in(outer, rs) -> list[str]:
    return [n for n, s, e in rs if outer[1] <= s and e <= outer[2] and (n, s, e) != outer]


def only(rs, name):
    got = [r for r in rs if r[0] == name]
    assert len(got) == 1, (name, rs)
    return got[0]


def test_span_without_a_profiler_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    assert span("zk.prove") is span("zk.sync")
    with span("zk.prove"):
        t = torch.arange(4)
    assert to_host(t) is t


def test_sumcheck_layers_open_their_spans(statement):
    """One test for the sumcheck's layers (the tier-1 test count is a
    setting: ROADMAP, Open items)."""
    poly, claim = statement
    # the device-transcript tier: a span a round, one read-back of the round
    # record, then one decode (the rows and the host tail), all inside zk.prove
    (proof, challenges), rs = ranges(lambda: prove(poly, claim))
    inner = names_in(only(rs, "zk.prove"), rs)
    assert len(inner) == len(rs) - 1
    assert inner.count("zk.prove.round") == 3 and inner.count("zk.sync") == 1
    assert inner.count("zk.prove.start") == 1 and inner.count("zk.prove.decode") == 1
    assert inner.index("zk.sync") < inner.index("zk.prove.decode")
    assert len(proof.round_polys) == N

    # the synced tier reads every round's sums back
    (synced, _), rs = ranges(lambda: SumcheckProver.prove_partial(poly, claim, tail_size=1, device_transcript=False))
    rounds = [r for r in rs if r[0] == "zk.prove.round"]
    assert synced == proof and len(rounds) == N
    assert [names_in(r, rs) for r in rounds] == [["zk.sync"]] * N
    assert [n for n, _, _ in rs].count("zk.sync") == N

    back, rs = ranges(lambda: proof_from_bytes(FR, proof_to_bytes(FR, proof)))
    assert back == proof and [n for n, _, _ in rs] == ["zk.proof.to_bytes", "zk.proof.from_bytes"]
    sub, rs = ranges(lambda: SumcheckVerifier.verify_partial(FR, proof))
    assert sub.challenges == challenges and [n for n, _, _ in rs] == ["zk.verify"]
    value, rs = ranges(lambda: poly.polynomials[0].evaluate(challenges))
    assert value == sub.sum
    assert names_in(only(rs, "zk.mle.evaluate"), rs) == ["zk.sync"] and len(rs) == 2


def test_gkr_stages_are_spans():
    c = Circuit([[Gate("mul", 0, 1)], [Gate("add", 0, 1), Gate("mul", 2, 3)]], n_inputs=4)
    (chain, _), rs = ranges(lambda: GKRProver.prove(GOLDILOCKS, c, [2, 3, 4, 5], device_transcript=True, device="cpu"))
    names = [n for n, _, _ in rs]
    for stage in ("witness", "bind_outputs", "layer_chain", "parse_outputs", "final_sync"):
        only(rs, f"zk.gkr.{stage}")
    assert names.count("zk.sync") == 2  # the output layer's bytes, then every proof component
    assert set(names_in(only(rs, "zk.gkr.layer_chain"), rs)) == {"zk.prove.round"}

    (per_phase, _), rs = ranges(lambda: GKRProver.prove(GOLDILOCKS, c, [2, 3, 4, 5], device="cpu"))
    assert per_phase == chain
    names = [n for n, _, _ in rs]
    for stage in ("eq_r_table", "phase1_tables", "phase1_sumcheck", "phase2_tables", "phase2_sumcheck",
                  "line_restriction"):
        assert names.count(f"zk.gkr.{stage}") == c.depth, stage
    assert all("zk.prove" in names_in(r, rs) for r in rs if r[0] == "zk.gkr.phase1_sumcheck")
