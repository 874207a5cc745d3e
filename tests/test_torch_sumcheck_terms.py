"""General-degree sumcheck rounds against zk_tpu, exact (tolerance 0).

fold_plain             vs zk_tpu.sumcheck._fold_kernel
round_sums_terms_plain vs zk_tpu.sumcheck._round_sums_kernel (decoded)
(BLS12-381 cases of these two against their definitions in host ints:
a JAX BLS12-381 compile of them costs 10-30 s on the CPU)
SumcheckProver on a two-term SumOfProducts above the host tail, in every
tier, vs zk_tpu's SumcheckProver._prove_internal, with and without
binding the claimed sum.

The same seeded numpy tables go to both packages, each with its own field
object.  The CUDA kernels run only on a card: the ``cuda`` test compares
them with the plain versions there and skips elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_tpu import fields as jfields
from zk_tpu import sumcheck as jsc
from zk_tpu.fields import device as jdev
from zk_tpu.poly import MLE as JMLE
from zk_tpu.poly import ProductPoly as JProductPoly
from zk_tpu.poly import SumOfProducts as JSumOfProducts
from zk_tpu.transcript import Transcript as JTranscript
from zk_tpu_torch import MLE, ProductPoly, SumcheckProver, SumcheckVerifier, SumOfProducts, interop
from zk_tpu_torch.fields import BLS12_381_FR, GOLDILOCKS
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.sumcheck import capacity as C
from zk_tpu_torch.sumcheck import kernels as K
from zk_tpu_torch.sumcheck import proof_to_bytes
from zk_tpu_torch.transcript import Transcript
from torch_helpers import host_ints, lerp_int, mont_limbs, once_per_session

torch.set_num_threads(1)

JF = {f.name: f for f in (jfields.GOLDILOCKS, jfields.BLS12_381_FR)}
TF = {f.name: f for f in (GOLDILOCKS, BLS12_381_FR)}


def _table(field, shape, seed):
    """Random Montgomery limbs (< p), as a numpy uint32 array."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    top = (field.p >> (16 * (field.n_limbs - 1))).bit_length() - 1
    a[..., field.n_limbs - 1, :] &= (1 << top) - 1
    return a


def _cpu(arr):
    return interop.limbs_from_numpy(arr, "cpu")


def _jtables(data, term_ks):
    """(K, L, n) rows -> zk_tpu's tuple (per term) of tuples of tables."""
    out, row = [], 0
    for k in term_ks:
        out.append(tuple(jnp.asarray(data[row + j]) for j in range(k)))
        row += k
    return tuple(out)


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("field", list(TF))
def test_fold_plain_matches_fold_kernel(field, k):
    """Goldilocks against JAX's fold; BLS12-381 against the fold's
    definition in host ints (no JAX BLS12-381 compile)."""
    jf, field = JF[field], TF[field]
    n, L = 9, field.n_limbs
    data = _table(field, (k, L, 1 << n), 80 + k)
    r_int = 0x5EED1234ABCD % field.p
    if field is GOLDILOCKS:
        want = [np.asarray(w) for w in jsc._fold_kernel(jf, _jtables(data, (k,)), jdev.scalar(jf, r_int))[0]]
    else:
        h = 1 << (n - 1)
        want = []
        for t in range(k):
            vals = host_ints(field, data[t])
            want.append(mont_limbs(field, [lerp_int(field, vals[e], vals[e + h], r_int) for e in range(h)]))
    stack, tr = _cpu(data), dev.scalar(field, r_int, device="cpu")
    fresh = C.fold(field, stack, 1 << n, tr, out=stack.new_empty((k, L, 1 << (n - 1))))
    for t in range(k):
        np.testing.assert_array_equal(interop.limbs_to_numpy(fresh[t]), want[t])
    inplace = stack.clone()
    C.fold(field, inplace, 1 << n, tr, out=inplace)
    assert torch.equal(inplace[:, :, : 1 << (n - 1)], fresh)
    assert torch.equal(C.fold_plain(field, stack, 1 << n, tr, stack.clone()), inplace)


def _host_round_sums(field, degree, term_ks, data):
    """The round-poly sums of a sum of products at 0..degree, by their
    definition in host ints: sum over pairs and terms of the product of
    the factors' lerps at each point."""
    rows = [host_ints(field, d) for d in data]
    h = len(rows[0]) // 2
    sums = []
    for pt in range(degree + 1):
        total, row = 0, 0
        for k in term_ks:
            for e in range(h):
                prod = 1
                for j in range(row, row + k):
                    prod = prod * lerp_int(field, rows[j][e], rows[j][e + h], pt) % field.p
                total += prod
            row += k
        sums.append(total % field.p)
    return sums


@pytest.mark.parametrize("term_ks", [(2, 1), (2, 2)], ids=str)
@pytest.mark.parametrize("field", list(TF))
def test_round_sums_terms_plain_matches_round_sums_kernel(field, term_ks):
    """Goldilocks against JAX's _round_sums_kernel; BLS12-381 against the
    sums' definition in host ints (no JAX BLS12-381 compile)."""
    jf, field = JF[field], TF[field]
    n = 8
    data = _table(field, (sum(term_ks), field.n_limbs, 1 << n), 90 + sum(term_ks))
    if field is GOLDILOCKS:
        want = jsc._round_sums_kernel(jf, 2, _jtables(data, term_ks))  # (D+1, L) Montgomery
        want = jdev.decode_ints(jf, np.asarray(want).T)
    else:
        want = _host_round_sums(field, 2, term_ks, data)
    got = C.round_sums_terms(field, 2, term_ks, _cpu(data), 1 << n)
    assert got.shape == (3, field.n_limbs, C.partition(1 << (n - 1), 2)[0])
    assert torch.equal(got, C.round_sums_terms_plain(field, 2, term_ks, _cpu(data), 1 << n))
    assert K.decode_sums(field, got) == want


def test_round_sums_terms_checks_shapes_and_bound():
    F = GOLDILOCKS
    stack = torch.zeros((3, F.n_limbs, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not split"):
        C.round_sums_terms(F, 2, (2, 2), stack, 16)
    with pytest.raises(ValueError, match="degree"):
        C.round_sums_terms(F, 4, (2, 1), stack, 16)
    with pytest.raises(ValueError):
        C.fold(F, stack, 16, torch.zeros((F.n_limbs, 2), dtype=torch.int32), out=stack)
    # the u32 accumulators take at most 2^16 limbs per thread, terms counted
    G, chunk = C.partition(1 << 30, 1)
    assert -(-chunk // C.THREADS) <= 1 << 16
    with pytest.raises(ValueError, match="accumulator bound"):
        C.partition(1 << 40, 2)


# --------------------------------------------------------------------------
# general-degree proves, every tier, against zk_tpu
# --------------------------------------------------------------------------

SIZES = {"Goldilocks": 12, "BLS12-381-Fr": 12}


def _sop_data(field, n):
    """The GKR phase-2 shape: two terms of two factors each."""
    return _table(field, (4, field.n_limbs, 1 << n), 100 + n)


def _port_sop(field, data):
    n = data.shape[-1].bit_length() - 1
    m = [MLE(field, n, _cpu(data[i])) for i in range(4)]
    return SumOfProducts([ProductPoly(m[:2]), ProductPoly(m[2:])])


def _claim(poly):
    """The true sum over the hypercube (host ints)."""
    f = poly.field
    vals = [[p.evaluation_ints() for p in t.polynomials] for t in poly.terms]
    return sum(a * b for t in vals for a, b in zip(*t)) % f.p


def _jax_proofs():
    out = {}
    for name, n in SIZES.items():
        jf, tf = JF[name], TF[name]
        data = _sop_data(tf, n)
        m = [JMLE(jf, n, jnp.asarray(data[i])) for i in range(4)]
        jpoly = JSumOfProducts([JProductPoly(m[:2]), JProductPoly(m[2:])])
        total = _claim(_port_sop(tf, data))
        for bind in (True, False):
            tr = JTranscript()
            tr.append(b"layer prefix")
            proof, chs = jsc.SumcheckProver._prove_internal(
                jpoly, total, tr, max_var_degree=2, tail_size=1 << 30, bind_sum=bind
            )
            out[f"{name}/{bind}"] = (jsc.proof_to_bytes(jf, proof).hex(), chs, tr.sample_challenge().hex())
    return out


@pytest.fixture(scope="module")
def jax_proofs(tmp_path_factory):
    """zk_tpu's proofs of each table, with and without the sum bound (its
    exact host tier, which its own tests hold equal to its device tiers),
    computed once per session."""
    runs = once_per_session(tmp_path_factory, "jax_sum_of_products_proofs", _jax_proofs)
    return {(key.split("/")[0], key.endswith("True")): (bytes.fromhex(proof), chs, bytes.fromhex(nxt))
            for key, (proof, chs, nxt) in runs.items()}


TIERS = {
    "synced": dict(device_transcript=False),
    "synced_no_tail": dict(device_transcript=False, tail_size=1),
    "device_transcript": dict(device_transcript=True),
    "device_transcript_no_tail": dict(device_transcript=True, tail_size=1),
    "host": dict(device_transcript=False, tail_size=1 << 30),
}


@pytest.mark.parametrize("bind", [True, False], ids=["bind_sum", "no_bind_sum"])
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("field", list(SIZES))
def test_sum_of_products_prove_matches_jax(jax_proofs, field, tier, bind):
    tf = TF[field]
    data = _sop_data(tf, SIZES[field])
    poly = _port_sop(tf, data)
    tr = Transcript()
    tr.append(b"layer prefix")
    proof, chs = SumcheckProver._prove_internal(
        poly, _claim(poly), tr, max_var_degree=2, bind_sum=bind, **TIERS[tier]
    )
    want, want_chs, want_next = jax_proofs[field, bind]
    assert proof_to_bytes(tf, proof) == want
    assert chs == want_chs
    assert tr.sample_challenge() == want_next  # the caller's transcript carries on in step
    assert torch.equal(poly.terms[0].polynomials[0].data, _cpu(data[0]))  # tables untouched


def test_sum_of_products_verify_and_oracle():
    field = GOLDILOCKS
    poly = _port_sop(field, _sop_data(field, 6))
    proof = SumcheckProver.prove(poly, _claim(poly), max_var_degree=2)
    assert SumcheckVerifier.verify(poly, proof)
    assert poly.max_degree == 2
    assert poly.to_bytes() == b"".join(p.to_bytes() for t in poly.terms for p in t.polynomials)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("field", list(TF))
def test_cuda_fold_and_round_sums_terms_match_plain(cuda, field):
    field = TF[field]
    L, n = field.n_limbs, 12
    stack = interop.limbs_from_numpy(_table(field, (4, L, 1 << n), 110), cuda)
    r = interop.limbs_from_numpy(_table(field, (L, 1), 111), cuda)
    for k in (1, 2, 3, 4, 5):
        s = stack[:k].contiguous() if k <= 4 else torch.cat([stack, stack[:1]])
        got = C.fold(field, s, 1 << n, r, out=s.new_empty((k, L, 1 << (n - 1))))
        assert torch.equal(got, C.fold_plain(field, s, 1 << n, r, s.new_zeros((k, L, 1 << (n - 1)))))
    for ks in ((2, 1), (2, 2)):
        s = stack[: sum(ks)].contiguous()
        assert torch.equal(C.round_sums_terms(field, 2, ks, s, 1 << n), C.round_sums_terms_plain(field, 2, ks, s, 1 << n))
