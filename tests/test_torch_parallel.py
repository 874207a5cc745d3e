"""The port's sharded paths (zk_tpu_torch.parallel, GKRProver.prove(mesh=))
against single-device proofs, exact (tolerance 0).

One gloo group of 4 CPU ranks runs once per test session
(tests/torch_parallel_ranks.py, behind ``once_per_session``, with a
timeout): every rank proves every case on the 4-rank mesh ("x4"), the
(2, 2) DeviceMesh ("2x2") and a 2-rank row of it ("x2").  The tests read
its JSON results and hold each case, on each mesh and each rank, against
the port's single-device proof computed here, and Goldilocks sumchecks
also against zk_tpu's single-device proof (its exact host-int tier: no
JAX compile, no JAX mesh).  The BLS12-381 sumcheck is held against the
port's host-int tier, the BLS12-381 GKR proof against
tests/goldens/gkr_d3w8_prove.bin.  The reference's sharded tests
(tests/test_sharded_*.py) are the cases' counterparts.
"""

import functools
import hashlib
import json
import os
import subprocess
import sys

import pytest
import torch

from zk_tpu import fields as jfields
from zk_tpu import gkr as jgkr
from zk_tpu import sumcheck as jsc
from zk_tpu.poly import MLE as JMLE
from zk_tpu.poly import ProductPoly as JProductPoly
from zk_tpu.poly import SumOfProducts as JSumOfProducts
from zk_tpu_torch import GKRProver, GKRVerifier, MLE, ProductPoly, SumcheckProver
from zk_tpu_torch.fields import BLS12_381_FR
from zk_tpu_torch.gkr import gkr_proof_from_bytes, gkr_proof_to_bytes
from zk_tpu_torch.parallel import ShardedSumcheckProver, make_mesh
from zk_tpu_torch.sumcheck import proof_to_bytes

import torch_parallel_ranks as R
from torch_helpers import once_per_session

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = ("x4", "2x2", "x2")
RANKS = ("0", "1", "2", "3")
SPAWN_TIMEOUT = 300  # seconds for the whole 4-rank run
JG = jfields.GOLDILOCKS


def _spawn_ranks(out_path: str) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_parallel_ranks.py"), out_path],
        env=env, capture_output=True, text=True, timeout=SPAWN_TIMEOUT,
    )
    if r.returncode != 0:
        raise AssertionError(f"the 4-rank gloo run failed (rc {r.returncode}):\n{r.stderr[-4000:]}")
    with open(out_path) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def sharded(tmp_path_factory):
    """case -> mesh -> rank -> result, from the one 4-rank run."""
    out = str(tmp_path_factory.mktemp("ranks") / "results.json")
    return once_per_session(tmp_path_factory, "torch_parallel_ranks", lambda: _spawn_ranks(out))


def _every_rank(sharded, case: str, mesh: str) -> list:
    by_rank = sharded[case][mesh]
    assert sorted(by_rank) == list(RANKS)
    return [by_rank[r] for r in RANKS]


@functools.lru_cache(maxsize=None)
def _single_device(case: str, claimed: int | None = None):
    """(proof bytes hex, challenges) of the port's single-device prover
    (its host-int tier), at the true sum unless ``claimed`` is given."""
    poly = R.sumcheck_poly(case)
    claimed = R.claimed_sum(poly) if claimed is None else claimed
    proof, chs = SumcheckProver.prove_partial(poly, claimed, R.SUMCHECK[case][3], tail_size=1 << 30)
    return proof_to_bytes(poly.field, proof).hex(), chs


def _jax_single_device() -> dict:
    """zk_tpu's single-device proofs of the Goldilocks cases, its host-int
    tier (tail_size past the table: no jit)."""
    out = {}
    for case, (field_name, n, seeds, degree, _, _) in R.SUMCHECK.items():
        if field_name != "Goldilocks":
            continue
        port = R.sumcheck_poly(case)
        port_terms = port.terms if hasattr(port, "terms") else [port]
        terms = [
            JProductPoly([JMLE.new(JG, n, m.evaluation_ints()) for m in t.polynomials]) for t in port_terms
        ]
        poly = terms[0] if len(terms) == 1 else JSumOfProducts(terms)
        proof, chs = jsc.SumcheckProver.prove_partial(poly, R.claimed_sum(port), degree, tail_size=1 << 30)
        out[case] = [jsc.proof_to_bytes(JG, proof).hex(), chs]
    return out


@pytest.fixture(scope="session")
def jax_proofs(tmp_path_factory):
    return once_per_session(tmp_path_factory, "jax_sharded_references", _jax_single_device)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(R.SUMCHECK))
def test_sharded_sumcheck_matches_single_device(sharded, jax_proofs, case, mesh):
    want_proof, want_chs = _single_device(case)
    for got in _every_rank(sharded, case, mesh):
        assert got["proof"] == want_proof
        assert got["challenges"] == want_chs
    if case in jax_proofs:
        assert jax_proofs[case] == [want_proof, want_chs]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", R.PRESHARDED)
def test_presharded_stack(sharded, case, mesh):
    """A ShardedStack proves the single-device bytes twice (its buffer
    survives a prove), and a prove on another mesh raises ValueError."""
    want_proof, want_chs = _single_device(case, 0)  # the ranks prove the stack at sum 0
    for runs in _every_rank(sharded, f"presharded_{case}", mesh):
        assert [(r["proof"], r["challenges"]) for r in runs] == [(want_proof, want_chs)] * 2
    for err in _every_rank(sharded, f"wrong_mesh_{case}", mesh):
        assert err == "ShardedStack was built for a different mesh"


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_ntt_matches_single_device(sharded, mesh):
    from zk_tpu_torch.ntt import ntt_device

    field, data = R.ntt_input("goldilocks")
    want = hashlib.sha256(ntt_device(field, data).numpy().tobytes()).hexdigest()
    for got in _every_rank(sharded, "ntt_goldilocks", mesh):
        assert got == {"forward": want, "roundtrip": True}
    for err in _every_rank(sharded, "ntt_bad_size", mesh):
        if mesh == "x2":
            assert err == "accepted"  # 2 x 4 divides over 2 ranks
        else:
            assert err == "both NTT factors (2, 4) must be divisible by mesh size 4"


@functools.lru_cache(maxsize=None)
def _gkr_single_device(case: str) -> str:
    field, circuit, inputs = R.gkr_case(case)
    proof, _ = GKRProver.prove(field, circuit, inputs, device="cpu")
    return gkr_proof_to_bytes(field, proof).hex()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(R.GKR))
def test_sharded_gkr_matches_single_device(sharded, case, mesh):
    """Sharded GKR bytes are the single-device bytes; both packages'
    verifiers accept them (``goldilocks_small_layers``: every phase is too
    small to shard on 4 ranks and runs single-device, as the reference's)."""
    want = _gkr_single_device(case)
    for got in _every_rank(sharded, f"gkr_{case}", mesh):
        assert got == want
    field, circuit, inputs = R.gkr_case(case)
    data = bytes.fromhex(want)
    assert GKRVerifier.verify(field, circuit, inputs, gkr_proof_from_bytes(field, data), device="cpu")
    jc = jgkr.Circuit([[jgkr.Gate(g.op, g.left, g.right) for g in layer] for layer in circuit.layers], circuit.n_inputs)
    assert jgkr.GKRVerifier.verify(JG, jc, inputs, jgkr.gkr_proof_from_bytes(JG, data))


def test_sharded_bls_gkr_matches_golden(sharded):
    with open(os.path.join(HERE, "goldens", "gkr_d3w8_prove.bin"), "rb") as f:
        golden = f.read().hex()
    for got in _every_rank(sharded, "gkr_bls_d3w8", "x2"):
        assert got == golden


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(device_type="cpu")


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_nccl_world_size_1_prove_matches_single_device(cuda, tmp_path):
    """A 2^16 BLS12-381 prove on a world-size-1 NCCL mesh is the
    single-device proof."""
    dist = torch.distributed
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'init'}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        poly = ProductPoly([MLE.random(BLS12_381_FR, 16, torch.Generator(device=cuda).manual_seed(7))])
        got = ShardedSumcheckProver.prove_partial(mesh, poly, 5, max_var_degree=1)
        assert got == SumcheckProver.prove_partial(poly, 5, max_var_degree=1)
    finally:
        dist.destroy_process_group()
