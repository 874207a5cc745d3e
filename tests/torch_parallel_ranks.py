"""The ranks of tests/test_torch_parallel.py: one gloo group of 4 CPU ranks.

Run as ``OMP_NUM_THREADS=1 OPENBLAS_NUM_THREADS=1 python
tests/torch_parallel_ranks.py OUT.json``.  The launcher imports torch,
numpy and zk_tpu_torch once, warms the port's caches with one tiny prove
per field, checks that it is still a single thread (the two variables
keep numpy's and torch's pools from starting) and forks the four ranks: a
fork copies the imports and caches, and with no other thread there is no
lock to inherit.  Every rank runs every case on three meshes: the
4-rank mesh ("x4"), the (2, 2) DeviceMesh ("2x2", collectives over all
four ranks in row-major order) and its inner 2-rank row ("x2": ranks
{0, 1} and {2, 3} each run the case on their own).  Each rank writes its
results, keyed case -> mesh -> rank; the launcher merges them into
OUT.json and exits non-zero if a rank failed or outlived its timeout.
Results are hex proof bytes, challenges and digests of outputs; the
tests hold them against single-device references they compute
themselves.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import random
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zk_tpu_torch import MLE, GKRProver, ProductPoly, SumcheckProver, SumOfProducts  # noqa: E402
from zk_tpu_torch.fields import BLS12_381_FR, F17, GOLDILOCKS  # noqa: E402
from zk_tpu_torch.gkr import gkr_proof_to_bytes  # noqa: E402
from zk_tpu_torch.gkr.circuit import Circuit, Gate  # noqa: E402
from zk_tpu_torch.parallel import ShardedSumcheckProver, gather_natural, make_mesh, ntt_sharded  # noqa: E402
from zk_tpu_torch.sumcheck import proof_to_bytes  # noqa: E402

WORLD = 4
TIMEOUT = 240  # seconds a rank may take
FIELDS = {f.name: f for f in (F17, GOLDILOCKS, BLS12_381_FR)}


def random_mle(field, n: int, seed: int) -> MLE:
    rng = random.Random(seed)
    return MLE.new(field, n, [rng.randrange(field.p) for _ in range(1 << n)], device="cpu")


def random_circuit(rng, depth: int, width: int, n_inputs: int, gate=Gate) -> list:
    """tests/test_gkr.py's seeded layered circuit."""
    layers, below = [], n_inputs
    for d in range(depth):
        size = width if d < depth - 1 else max(1, width // 2)
        layers.append([
            gate("add" if rng.random() < 0.5 else "mul", rng.randrange(below), rng.randrange(below))
            for _ in range(size)
        ])
        below = size
    layers.reverse()
    return layers


# sumcheck cases: name -> (field, n_vars, table seeds per term, max_var_degree, device_transcript, tail_size)
SUMCHECK = {
    "f17_deg1": ("F17", 7, ((1,),), 1, None, None),
    "f17_deg2": ("F17", 6, ((2, 3),), 2, None, None),
    "goldilocks_deg1": ("Goldilocks", 7, ((1,),), 1, None, None),
    "goldilocks_deg1_device": ("Goldilocks", 5, ((1,),), 1, True, None),
    "goldilocks_sop": ("Goldilocks", 6, ((4, 5), (6,)), 2, None, None),
    "goldilocks_sop_device": ("Goldilocks", 5, ((4, 5), (6,)), 2, True, None),
    "goldilocks_tail_device": ("Goldilocks", 6, ((7,),), 1, True, 16),
    "goldilocks_tail": ("Goldilocks", 6, ((2, 3),), 2, None, 16),
    "bls_deg1_device": ("BLS12-381-Fr", 4, ((8,),), 1, True, None),
}
PRESHARDED = ("goldilocks_deg1", "f17_deg2")
NTT = {"goldilocks": ("Goldilocks", 10, 9)}
GKR = {  # name -> (field, rng seed, depth, width)
    "goldilocks_sharded": ("Goldilocks", 11, 2, 8),
    "goldilocks_small_layers": ("Goldilocks", 12, 2, 4),
}


def sumcheck_poly(name: str):
    field_name, n, seeds, *_ = SUMCHECK[name]
    field = FIELDS[field_name]
    terms = [ProductPoly([random_mle(field, n, s) for s in term]) for term in seeds]
    return terms[0] if len(terms) == 1 else SumOfProducts(terms)


def claimed_sum(poly) -> int:
    """The sum of the polynomial over the hypercube (host ints)."""
    field = poly.field
    terms = poly.terms if isinstance(poly, SumOfProducts) else [poly]
    total = 0
    for term in terms:
        for vals in zip(*(m.evaluation_ints() for m in term.polynomials)):
            prod = 1
            for v in vals:
                prod = prod * v % field.p
            total += prod
    return total % field.p


def gkr_case(name: str):
    field_name, seed, depth, width = GKR[name]
    field = FIELDS[field_name]
    rng = random.Random(seed)
    circuit = Circuit(random_circuit(rng, depth, width, width), n_inputs=width)
    return field, circuit, [rng.randrange(field.p) for _ in range(width)]


def d3w8(field):
    """The golden circuit (tests/goldens/gkr_d3w8_prove.bin): random.Random(7),
    depth 3, width 8, 8 inputs."""
    rng = random.Random(7)
    circuit = Circuit(random_circuit(rng, 3, 8, 8), n_inputs=8)
    return circuit, [rng.randrange(field.p) for _ in range(8)]


def ntt_input(name: str):
    field_name, log_n, seed = NTT[name]
    return FIELDS[field_name], random_mle(FIELDS[field_name], log_n, seed).data


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.to(torch.int32).contiguous().numpy().tobytes()).hexdigest()


def run_cases(mesh, other_mesh) -> dict:
    out = {}
    for name, (_, _, _, degree, device_transcript, tail) in SUMCHECK.items():
        poly = sumcheck_poly(name)
        proof, chs = ShardedSumcheckProver.prove_partial(
            mesh, poly, claimed_sum(poly), degree, device_transcript=device_transcript, tail_size=tail
        )
        out[name] = {"proof": proof_to_bytes(poly.field, proof).hex(), "challenges": chs}

    # a pre-sharded stack, proven twice (its buffer must survive), and on the wrong mesh
    for name in PRESHARDED:
        poly = sumcheck_poly(name)
        stack = ShardedSumcheckProver.shard(mesh, poly)
        degree, device_transcript = SUMCHECK[name][3:5]
        runs = [ShardedSumcheckProver.prove_partial(mesh, stack, 0, degree, device_transcript) for _ in range(2)]
        out[f"presharded_{name}"] = [
            {"proof": proof_to_bytes(poly.field, p).hex(), "challenges": c} for p, c in runs
        ]
        try:
            ShardedSumcheckProver.prove_partial(other_mesh, stack, 0, degree, device_transcript)
            out[f"wrong_mesh_{name}"] = "accepted"
        except ValueError as e:
            out[f"wrong_mesh_{name}"] = str(e)

    for name in NTT:
        field, data = ntt_input(name)
        fwd = gather_natural(mesh, field, ntt_sharded(mesh, field, data))
        back = gather_natural(mesh, field, ntt_sharded(mesh, field, fwd, inverse=True))
        out[f"ntt_{name}"] = {"forward": digest(fwd), "roundtrip": bool(torch.equal(back, data))}
    try:  # 2^3 = 2 x 4: a factor the 4-rank mesh does not divide
        ntt_sharded(mesh, GOLDILOCKS, ntt_input("goldilocks")[1][:, :8])
        out["ntt_bad_size"] = "accepted"
    except ValueError as e:
        out["ntt_bad_size"] = str(e)

    for name in GKR:
        field, circuit, inputs = gkr_case(name)
        proof, _ = GKRProver.prove(field, circuit, inputs, device="cpu", mesh=mesh)
        out[f"gkr_{name}"] = gkr_proof_to_bytes(field, proof).hex()
    return out


def run_bls_gkr(mesh) -> dict:
    """The golden BLS12-381 circuit (on the 2-rank mesh only: a BLS GKR
    prove is the dearest case on the CPU)."""
    circuit, inputs = d3w8(BLS12_381_FR)
    proof, _ = GKRProver.prove(BLS12_381_FR, circuit, inputs, device="cpu", mesh=mesh)
    return {"gkr_bls_d3w8": gkr_proof_to_bytes(BLS12_381_FR, proof).hex()}


def rank_main(rank: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=WORLD)
    try:
        x4 = make_mesh(device_type="cpu")
        m2x2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("dcn", "ici"))
        x2 = m2x2["ici"]
        results = {}
        for mesh_name, mesh, other in (("x4", x4, x2), ("2x2", m2x2, x4), ("x2", x2, x4)):
            cases = run_cases(mesh, other)
            if mesh_name == "x2":
                cases.update(run_bls_gkr(mesh))
            for case, value in cases.items():
                results.setdefault(case, {}).setdefault(mesh_name, {})[str(rank)] = value
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def main(out_path: str) -> int:
    torch.set_num_threads(1)
    for field in FIELDS.values():  # fill the port's caches once, before the fork
        SumcheckProver.prove_partial(ProductPoly([random_mle(field, 3, 0)]), 0)
    threads = len(os.listdir("/proc/self/task"))
    if threads != 1:
        raise RuntimeError(f"the launcher runs {threads} threads: forking it is unsafe")
    ctx = multiprocessing.get_context("fork")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "init")
        procs = [ctx.Process(target=rank_main, args=(r, init_file, tmp)) for r in range(WORLD)]
        try:
            for p in procs:
                p.start()
            for p in procs:
                p.join(TIMEOUT)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * WORLD:
            print(f"rank exit codes {codes}", file=sys.stderr)
            return 1
        merged: dict = {}
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                for case, by_mesh in json.load(f).items():
                    for mesh_name, by_rank in by_mesh.items():
                        merged.setdefault(case, {}).setdefault(mesh_name, {}).update(by_rank)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
