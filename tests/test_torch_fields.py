"""The torch limb tier against zk_tpu.fields.device, limb for limb.

Inputs are seeded with numpy, encoded by the JAX package, and handed to
the port through zk_tpu_torch.interop; every comparison is exact (field
arithmetic has no rounding: tolerance 0).  The ops of the two BLS fields
are held against their definitions in host ints instead of JAX's limb
tier (a JAX compile of a BLS op costs seconds on the CPU); Goldilocks
stays against JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_tpu import fields as jfields
from zk_tpu.fields import device as jdev
from zk_tpu_torch import fields as tfields
from zk_tpu_torch import interop
from zk_tpu_torch.fields import device as tdev
from torch_helpers import host_ints, lerp_int, mont_limbs

torch.set_num_threads(1)

# each package gets its own field object of the same name
FIELDS = ["Goldilocks", "BLS12-381-Fr", "BLS12-377-Fr"]
JF = {f.name: f for f in (jfields.GOLDILOCKS, jfields.BLS12_381_FR, jfields.BLS12_377_FR)}
TF = {f.name: f for f in (tfields.GOLDILOCKS, tfields.BLS12_381_FR, tfields.BLS12_377_FR)}
N = 256


def _ints(field, seed, n=N):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(field.n_bytes + 8), "big") % field.p for _ in range(n)]
    vals[:3] = [0, 1, field.p - 1]  # edges
    return vals


def _pair(field, seed):
    """The same (L, N) Montgomery limbs in both packages."""
    j = jdev.encode_ints(field, _ints(field, seed))
    return j, interop.limbs_from_numpy(np.asarray(j), "cpu")


def _same(t, j):
    np.testing.assert_array_equal(interop.limbs_to_numpy(t), np.asarray(j))


OPS = {
    "add_mod": (lambda d, f, a, b, r: d.add_mod(f, a, b)),
    "sub_mod": (lambda d, f, a, b, r: d.sub_mod(f, a, b)),
    "neg_mod": (lambda d, f, a, b, r: d.neg_mod(f, a)),
    "mont_mul": (lambda d, f, a, b, r: d.mont_mul(f, a, b)),
    "lerp": (lambda d, f, a, b, r: d.lerp(f, a, b, r)),
    "to_mont": (lambda d, f, a, b, r: d.to_mont(f, a)),
    "from_mont": (lambda d, f, a, b, r: d.from_mont(f, a)),
    "sum_mod": (lambda d, f, a, b, r: d.sum_mod(f, a, -1)),
}


def _host_op(field, op, a, b, r):
    """The op on canonical values, as the limbs the torch tier returns."""
    p, R = field.p, field.R
    if op == "to_mont":  # the input limbs read as a canonical value A
        return mont_limbs(field, [v * R % p for v in a])
    if op == "from_mont":
        return mont_limbs(field, [v * pow(R, -1, p) % p for v in a])
    if op == "sum_mod":
        return mont_limbs(field, [sum(a)])
    fn = {
        "add_mod": lambda u, v: u + v,
        "sub_mod": lambda u, v: u - v,
        "neg_mod": lambda u, v: -u,
        "mont_mul": lambda u, v: u * v,
        "lerp": lambda u, v: lerp_int(field, u, v, r),
    }[op]
    return mont_limbs(field, [fn(u, v) for u, v in zip(a, b)])


@pytest.mark.parametrize("op", list(OPS))
@pytest.mark.parametrize("field", FIELDS)
def test_op_matches_jax(field, op):
    jf, tf = JF[field], TF[field]
    r_int = 0x1234567890ABCDEF % jf.p
    if field == "Goldilocks":
        ja, ta = _pair(jf, 1)
        jb, tb = _pair(jf, 2)
        rj = jdev.scalar(jf, r_int)
        want = np.asarray(OPS[op](jdev, jf, ja, jb, rj))
    else:
        a, b = _ints(tf, 1), _ints(tf, 2)
        ta, tb = tdev.encode_ints(tf, a, device="cpu"), tdev.encode_ints(tf, b, device="cpu")
        want = _host_op(tf, op, a, b, r_int)
    got = OPS[op](tdev, tf, ta, tb, tdev.scalar(tf, r_int, device="cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), want.reshape(tuple(got.shape)))


@pytest.mark.parametrize("field", FIELDS)
def test_encode_decode_match_jax(field):
    jf, field = JF[field], TF[field]
    vals = _ints(field, 3)
    for mont in (True, False):
        t = tdev.encode_ints(field, vals, device="cpu", mont=mont)
        _same(t, jdev.encode_ints(jf, vals, mont=mont))
        assert tdev.decode_ints(field, t, mont=mont) == vals
    t = tdev.encode_ints(field, vals, device="cpu")
    assert tdev.decode_bytes_be(field, t) == field.elements_to_bytes(vals)
    assert tdev.decode_bytes_be(field, t) == jdev.decode_bytes_be(jf, np.asarray(interop.limbs_to_numpy(t)))
    back = tdev.encode_bytes_be(field, field.elements_to_bytes(vals), device="cpu")
    assert torch.equal(back, t)


@pytest.mark.parametrize("field", FIELDS)
def test_consts_match_jax(field):
    jf, field = JF[field], TF[field]
    for v in (0, 1, 2, field.p - 1, 12345):
        np.testing.assert_array_equal(tdev.const_limbs(field, v), jdev.const_limbs(jf, v))
        _same(tdev.scalar(field, v, device="cpu"), jnp.asarray(jdev.scalar(jf, v)))


@pytest.mark.parametrize("field", FIELDS)
def test_renorm_relaxed_matches_jax(field):
    """Raw limb sums of many Montgomery values (a scatter-add's output)
    renormalise to the reference's limbs."""
    jf, tf = JF[field], TF[field]
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 1 << 16, size=(200, jf.n_limbs, 7), dtype=np.uint32)
    raw[:, -1, :] &= (1 << ((jf.p >> (16 * (jf.n_limbs - 1))).bit_length() - 1)) - 1  # each < p
    x = raw.sum(axis=0, dtype=np.uint32)
    got = tdev.renorm_relaxed(tf, torch.from_numpy(x.astype(np.int64)))
    if field == "Goldilocks":
        _same(got, jdev.renorm_relaxed(jf, jnp.asarray(x)))
    else:  # the true sums' Montgomery limbs: host_ints reads the raw sums T as T R^-1
        np.testing.assert_array_equal(interop.limbs_to_numpy(got), mont_limbs(tf, host_ints(tf, x)))


@pytest.mark.parametrize("field", FIELDS)
def test_renorm_wide_against_host_ints(field):
    field = TF[field]
    """Wide int64 column sums of many Montgomery limbs reduce to the exact
    sum, canonical and Montgomery."""
    rng = np.random.default_rng(4)
    cols = torch.from_numpy(rng.integers(0, 1 << 40, size=(field.n_limbs, 5), dtype=np.int64))
    for c in range(5):
        v = sum(int(cols[j, c]) << (16 * j) for j in range(field.n_limbs))
        canon = tdev.renorm_wide(field, cols[:, c : c + 1], mont_out=False)
        mont = tdev.renorm_wide(field, cols[:, c : c + 1], mont_out=True)
        rinv = pow(field.R, -1, field.p)
        assert tdev.decode_ints(field, canon, mont=False) == [v * rinv % field.p]
        assert tdev.decode_ints(field, mont) == [v * rinv % field.p]
