"""zk_tpu_torch imports nothing of JAX or zk_tpu, puts its entry points on
the card by default, and never falls back from a kernel."""

import importlib
import os
import subprocess
import sys

import pytest
import torch

from zk_tpu_torch import MLE, GKRProver, UnivariatePolynomial, _cuda
from zk_tpu_torch.fields import BLS12_381_FR as FR
from zk_tpu_torch.fields import F17, GOLDILOCKS
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields import kernels as FK
from zk_tpu_torch.gkr.circuit import Circuit, Gate
from zk_tpu_torch.sumcheck import capacity as C
from zk_tpu_torch.sumcheck import kernels as K
from zk_tpu_torch.transcript import device as tdev

N = importlib.import_module("zk_tpu_torch.ntt")

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    """Every module of the port imports, and neither JAX nor any module of
    zk_tpu comes with it."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import zk_tpu_torch\n"
        "for m in pkgutil.walk_packages(zk_tpu_torch.__path__, 'zk_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('zk_tpu_torch.gkr.chain', 'zk_tpu_torch.ntt', 'zk_tpu_torch.fields.kernels',\n"
        "          'zk_tpu_torch.parallel', 'zk_tpu_torch.parallel.sumcheck', 'zk_tpu_torch.parallel.ntt',\n"
        "          'zk_tpu_torch.poly.coeff_mle', 'zk_tpu_torch.poly.pairing_index', 'zk_tpu_torch.utils.stat'):\n"
        "    assert m in sys.modules, m\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'zk_tpu') or m.startswith(('jax', 'zk_tpu.')))\n"
        "assert not bad, bad\n"
        "assert zk_tpu_torch._cuda._LIB is None  # importing builds nothing\n"
        "assert zk_tpu_torch.transcript.native._LIB is None\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    assert _cuda.find_nvcc() is None
    with pytest.raises(_cuda.KernelBuildError, match="nvcc not found"):
        _cuda.build()


def test_build_is_keyed_by_sources(monkeypatch, tmp_path):
    a = _cuda._digest()
    src = tmp_path / "csrc"
    src.mkdir()
    for p in _cuda.CSRC.glob("*.cu*"):
        (src / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_cuda, "CSRC", src)
    assert _cuda._digest() == a
    (src / "keccak.cu").write_text((src / "keccak.cu").read_text() + "\n// edit\n")
    assert _cuda._digest() != a


def test_launch_counter_reset_and_count():
    _cuda.reset_launches()
    assert set(_cuda.launches()) == set(_cuda.KERNELS)
    assert all(v == 0 for v in _cuda.launches().values())
    _cuda.count_launch("fold_multi")
    assert _cuda.launches()["fold_multi"] == 1
    _cuda.reset_launches()


def test_cpu_wrappers_do_not_count_launches():
    _cuda.reset_launches()
    L = FR.n_limbs
    stack = torch.zeros((1, L, 8), dtype=torch.int32)
    terms = torch.zeros((4, L, 8), dtype=torch.int32)
    r = torch.zeros((L, 1), dtype=torch.int32)
    C.fold_multi(FR, stack, 8, r, out=stack)
    C.round_sums(FR, 1, stack, 8)
    C.fold_halfsums(FR, stack, 8, r, out=stack)
    C.fold(FR, terms, 8, r, out=terms)
    C.round_sums_terms(FR, 2, (2, 2), terms, 8)
    z = torch.zeros(25, dtype=torch.int64)
    tdev.keccak_f1600_device(z, z)
    x = torch.zeros((L, 2, 8), dtype=torch.int32)
    a = torch.zeros((L, 8), dtype=torch.int32)
    N.ntt_ladder(FR, x, True)
    FK.mont_mul(FR, a, a)
    FK.lerp(FR, a, a, r)
    N.ntt(FR, list(range(2048)), device="cpu")  # two ladder levels, the upper one with its twiddles
    zb = torch.zeros(tdev.RATE, dtype=torch.int64)
    K.transcript_round(FR, 0, z, z, zb, torch.zeros((2, L, 3), dtype=torch.int64))
    assert all(v == 0 for v in _cuda.launches().values())


@pytest.mark.parametrize("kernel", ["fold_multi", "round_sums", "fold_halfsums", "keccak", "fold", "round_sums_terms",
                                    "ntt_ladder", "mont_mul", "lerp", "decode", "transcript_round"])
def test_no_fallback_on_other_devices(kernel):
    """A tensor that is neither on the CPU nor on a CUDA card raises; it
    never takes the plain version."""
    L = FR.n_limbs
    stack = torch.zeros((1, L, 8), dtype=torch.int32, device="meta")
    terms = torch.zeros((3, L, 8), dtype=torch.int32, device="meta")
    r = torch.zeros((L, 1), dtype=torch.int32, device="meta")
    z = torch.zeros(25, dtype=torch.int64, device="meta")
    calls = {
        "fold_multi": lambda: C.fold_multi(FR, stack, 8, r, out=stack),
        "round_sums": lambda: C.round_sums(FR, 1, stack, 8),
        "fold_halfsums": lambda: C.fold_halfsums(FR, stack, 8, r, out=stack),
        "keccak": lambda: tdev.keccak_f1600_device(z, z),
        "fold": lambda: C.fold(FR, terms, 8, r, out=terms),
        "round_sums_terms": lambda: C.round_sums_terms(FR, 2, (2, 1), terms, 8),
        "ntt_ladder": lambda: N.ntt_ladder(FR, stack.reshape(L, 8, 1), False),
        "mont_mul": lambda: FK.mont_mul(FR, stack[0], stack[0]),
        "lerp": lambda: FK.lerp(FR, stack[0], stack[0], r),
        "decode": lambda: dev.decode_ints(FR, stack[0]),  # un-scales through mont_mul
        "transcript_round": lambda: K.transcript_round(
            FR, 0, z, z, torch.zeros(tdev.RATE, dtype=torch.int64, device="meta"),
            torch.zeros((2, L, 3), dtype=torch.int64, device="meta")),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[kernel]()


def test_entry_points_default_to_the_card():
    """MLE.new, MLE.random and the GKR prover put their tensors on CUDA
    unless the caller names another device: without a card they raise,
    they never build a CPU tensor."""
    if torch.cuda.is_available():
        assert MLE.new(FR, 2, [1, 2, 3, 4]).data.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        MLE.new(FR, 2, [1, 2, 3, 4])
    with pytest.raises((RuntimeError, AssertionError)):
        MLE.random(FR, 2, torch.Generator())
    circuit = Circuit([[Gate("mul", 0, 1)]], n_inputs=2)
    with pytest.raises((RuntimeError, AssertionError)):
        GKRProver.prove(FR, circuit, [3, 5])
    with pytest.raises((RuntimeError, AssertionError)):
        N.ntt(FR, [1, 2, 3, 4])
    with pytest.raises((RuntimeError, AssertionError)):
        N.intt(FR, [1, 2, 3, 4])
    with pytest.raises((RuntimeError, AssertionError)):
        N.ntt_with_root(F17, [1, 2, 3, 4], 13)
    big = UnivariatePolynomial(FR, list(range(1, 200)))
    with pytest.raises((RuntimeError, AssertionError)):
        big * big  # 397 coefficients: the NTT route, on the card
    assert MLE.new(FR, 2, [1, 2, 3, 4], device="cpu").data.device.type == "cpu"


# --------------------------------------------------------------------------
# on the card only: the NTT path's kernels against their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand_limbs(field, shape, gen, device):
    t = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32)
    L = field.n_limbs
    t[L - 1] &= (1 << ((field.p >> (16 * (L - 1))).bit_length() - 1)) - 1  # < p
    return t.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [GOLDILOCKS, FR], ids=lambda f: f.name)
def test_cuda_ntt_ladder_matches_plain(cuda, field):
    gen = torch.Generator().manual_seed(3)
    for n_t, cols in ((2, 3), (16, 1), (N.LADDER_MAX, 5)):
        x = _rand_limbs(field, (field.n_limbs, n_t, cols), gen, cuda)
        for inverse in (False, True):
            assert torch.equal(N.ntt_ladder(field, x, inverse), N.ntt_ladder_plain(field, x, inverse))
            assert torch.equal(N.ntt_ladder(field, x, inverse, batch=cols), N.ntt_ladder_plain(field, x, inverse, batch=cols))


@pytest.mark.cuda
@pytest.mark.parametrize("field", [GOLDILOCKS, FR], ids=lambda f: f.name)
def test_cuda_mont_mul_and_lerp_match_plain(cuda, field):
    gen = torch.Generator().manual_seed(4)
    for n in (1, 1000, 1 << 12):
        a = _rand_limbs(field, (field.n_limbs, n), gen, cuda)
        b = _rand_limbs(field, (field.n_limbs, n), gen, cuda)
        r = _rand_limbs(field, (field.n_limbs, 1), gen, cuda)
        assert torch.equal(FK.mont_mul(field, a, b), FK.mont_mul_plain(field, a, b))
        assert torch.equal(FK.lerp(field, a, b, r), FK.lerp_plain(field, a, b, r))


@pytest.mark.cuda
def test_cuda_refuses_f17_naming_it(cuda):
    x = dev.encode_ints(F17, list(range(8)), device=cuda)
    with pytest.raises(ValueError, match="F17"):
        FK.mont_mul(F17, x, x)
    with pytest.raises(ValueError, match="F17"):
        N.ntt_device(F17, x)
    with pytest.raises(ValueError, match="F17"):
        dev.decode_ints(F17, x)
