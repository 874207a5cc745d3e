"""The table kernels' plain versions (and the CPU wrappers that run them)
against the JAX package's jnp tier, exact (tolerance 0).

fold_multi    vs zk_tpu.poly.mle._fold_kernel
round_sums    vs zk_tpu.sumcheck.kernels._sums_jnp_stack
fold_halfsums vs zk_tpu.sumcheck.kernels._fold_stack_inner + half sums

The BLS12-381 cases of the folds are held against the definition in host
ints instead, the oracle JAX's own CPU tests use for those functions: a
JAX BLS12-381 compile costs seconds per shape on the CPU.

The CUDA kernels themselves run only on a card: the ``cuda`` tests below
compare them with these plain versions there and skip elsewhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zk_tpu import fields as jfields
from zk_tpu.fields import device as jdev
from zk_tpu.poly.mle import _fold_kernel
from zk_tpu.sumcheck.kernels import _fold_stack_inner, _sums_jnp_stack
from zk_tpu_torch import interop
from zk_tpu_torch.fields import BLS12_377_FR, BLS12_381_FR, GOLDILOCKS
from zk_tpu_torch.fields import device as tdev
from zk_tpu_torch.fields.kernels import field_params
from zk_tpu_torch.poly.mle import MLE
from zk_tpu_torch.sumcheck import capacity as C
from torch_helpers import host_ints, lerp_int, mont_limbs

torch.set_num_threads(1)

# each package gets its own field object of the same name
JF = {f.name: f for f in (jfields.GOLDILOCKS, jfields.BLS12_381_FR)}
TF = {f.name: f for f in (GOLDILOCKS, BLS12_381_FR)}


def _cpu(arr):
    return interop.limbs_from_numpy(arr, "cpu")


def _table(field, shape, seed):
    """Random Montgomery limbs (< p), as a numpy uint32 array."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    top = (field.p >> (16 * (field.n_limbs - 1))).bit_length() - 1
    a[..., field.n_limbs - 1, :] &= (1 << top) - 1
    return a


def _mont_sums(field, partials):
    """(P, L, G) partials -> (L, P) Montgomery sums."""
    return tdev.renorm_wide(field, partials.sum(-1).t(), mont_out=True)


CASES = [("Goldilocks", 8, f) for f in (1, 2, 3, 4)] + [("BLS12-381-Fr", 6, 1)]


def _host_fold(field, vals, r):
    h = len(vals) // 2
    return [lerp_int(field, vals[e], vals[e + h], r) for e in range(h)]


@pytest.mark.parametrize("field,n,f", CASES, ids=lambda v: getattr(v, "name", v))
def test_fold_multi_plain_matches_fold_kernel(field, n, f):
    """Goldilocks against JAX's jnp fold; BLS12-381 against the fold's
    definition in host ints (a JAX BLS12-381 compile costs ~10 s here)."""
    jf, field = JF[field], TF[field]
    data = _table(field, (field.n_limbs, 1 << n), 10 + f)
    rs = _table(field, (field.n_limbs, f), 20 + f)
    if field is GOLDILOCKS:
        want = np.asarray(_fold_kernel(jf, n, 0, f, jnp.asarray(data), jnp.asarray(rs.T.copy())))
    else:
        vals = host_ints(field, data)
        for r in host_ints(field, rs):
            vals = _host_fold(field, vals, r)
        want = mont_limbs(field, vals)
    stack = _cpu(data).reshape(1, field.n_limbs, -1)
    t_rs = _cpu(rs)
    out = C.fold_multi_plain(field, stack, 1 << n, t_rs, stack.new_zeros((1, field.n_limbs, 1 << (n - f))))
    np.testing.assert_array_equal(interop.limbs_to_numpy(out[0]), want)
    # the CPU wrapper, in place and into a fresh buffer, is the same fold
    fresh = C.fold_multi(field, stack, 1 << n, t_rs, out=stack.new_empty((1, field.n_limbs, 1 << (n - f))))
    inplace = stack.clone()
    C.fold_multi(field, inplace, 1 << n, t_rs, out=inplace)
    assert torch.equal(fresh, out)
    assert torch.equal(inplace[:, :, : 1 << (n - f)], out)


@pytest.mark.parametrize("initial_var,k", [(0, 6), (0, 8), (2, 3)])
def test_mle_partial_evaluate_matches_fold_kernel(initial_var, k):
    field, n = GOLDILOCKS, 8
    jf = JF[field.name]
    data = _table(field, (field.n_limbs, 1 << n), 30)
    pts = [(0xABCDEF + 977 * i) % field.p for i in range(k)]
    rs = np.stack([jdev.const_limbs(jf, a) for a in pts])
    want = _fold_kernel(jf, n, initial_var, k, jnp.asarray(data), jnp.asarray(rs))
    mle = interop.mle_from_jax(field, n, data, "cpu")
    got = mle.partial_evaluate(initial_var, pts)
    assert got.n_vars == n - k
    np.testing.assert_array_equal(interop.limbs_to_numpy(got.data), np.asarray(want))
    assert torch.equal(mle.data, _cpu(data))  # input untouched


def test_mle_evaluate_against_host_ints():
    field, n = BLS12_381_FR, 7
    rng = np.random.default_rng(31)
    vals = [int(x) % field.p for x in rng.integers(0, 1 << 62, size=1 << n)]
    pt = [int(x) for x in rng.integers(0, 1 << 62, size=n)]
    cur = list(vals)
    for r in pt:
        h = len(cur) // 2
        cur = [(cur[e] - r * (cur[e] - cur[e + h])) % field.p for e in range(h)]
    mle = MLE.new(field, n, vals, device="cpu")
    assert mle.evaluate(pt) == cur[0]
    assert mle.evaluation_ints() == vals
    assert mle.to_bytes() == field.elements_to_bytes(vals)


RS_CASES = [("Goldilocks", 1, 1), ("Goldilocks", 2, 2), ("Goldilocks", 3, 1), ("BLS12-381-Fr", 1, 1)]


@pytest.mark.parametrize("field,degree,k", RS_CASES, ids=lambda v: getattr(v, "name", v))
def test_round_sums_plain_matches_sums_jnp_stack(field, degree, k):
    jf, field = JF[field], TF[field]
    n = 7
    data = _table(field, (k, field.n_limbs, 1 << n), 40 + degree + k)
    want = _sums_jnp_stack(jf, degree, jnp.asarray(data))  # (D+1, L)
    got = C.round_sums(field, degree, _cpu(data), 1 << n)
    assert got.shape == (degree + 1, field.n_limbs, C.partition(1 << (n - 1))[0])
    np.testing.assert_array_equal(interop.limbs_to_numpy(_mont_sums(field, got)), np.asarray(want).T)


def test_round_sums_partials_layout():
    """Partial g sums exactly the pair indices of chunk g (the layout the
    CUDA kernel's blocks write), here for a table large enough to have
    several chunks."""
    field, n = GOLDILOCKS, 12
    data = _table(field, (1, field.n_limbs, 1 << n), 50)
    got = C.round_sums(field, 1, _cpu(data), 1 << n).numpy()
    half = 1 << (n - 1)
    G, chunk = C.partition(half)
    assert G > 1
    for point, part in enumerate((data[0, :, :half], data[0, :, half:])):
        for g in range(G):
            np.testing.assert_array_equal(
                got[point, :, g], part[:, g * chunk : (g + 1) * chunk].astype(np.int64).sum(-1)
            )


@pytest.mark.parametrize("field", list(TF))
def test_fold_halfsums_plain_matches_fold_and_half_sums(field):
    """Goldilocks against JAX's jnp fold and sums; BLS12-381 against their
    definitions in host ints."""
    jf, field = JF[field], TF[field]
    n = 7
    data = _table(field, (1, field.n_limbs, 1 << n), 60)
    r_int = 0x1F2E3D4C5B6A % field.p
    if field is GOLDILOCKS:
        r = jdev.scalar(jf, r_int)
        folded = _fold_stack_inner(jf, 1, 1 << n, jnp.asarray(data), r)
        halves = _sums_jnp_stack(jf, 1, folded)  # (2, L): p(0), p(1) of the next round
        folded, halves = np.asarray(folded), np.asarray(halves).T
    else:
        vals = _host_fold(field, host_ints(field, data[0]), r_int)
        q = len(vals) // 2
        folded = mont_limbs(field, vals)[None]
        halves = mont_limbs(field, [sum(vals[:q]), sum(vals[q:])])
    stack = _cpu(data)
    r = tdev.scalar(field, r_int, device="cpu")
    out, acc = C.fold_halfsums(field, stack, 1 << n, r, out=stack)
    np.testing.assert_array_equal(interop.limbs_to_numpy(out[:, :, : 1 << (n - 1)]), folded)
    np.testing.assert_array_equal(interop.limbs_to_numpy(_mont_sums(field, acc)), halves)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1 << 12, 1 << 23, 1 << 30])
def test_partition_covers_and_respects_u32_bound(n):
    G, chunk = C.partition(n)
    assert 1 <= G <= C.MAX_PARTIALS
    assert G * chunk >= n > (G - 1) * chunk
    assert -(-chunk // C.THREADS) <= 1 << 16  # terms per thread accumulator


def test_wrappers_reject_bad_inputs():
    F = GOLDILOCKS
    L = F.n_limbs
    stack = torch.zeros((1, L, 16), dtype=torch.int32)
    r = torch.zeros((L, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        C.round_sums(F, 1, stack.long(), 16)
    with pytest.raises(ValueError):
        C.round_sums(F, 1, stack, 12)  # not a power of two
    with pytest.raises(ValueError):
        C.fold_multi(F, stack, 16, torch.zeros((L, 5), dtype=torch.int32), out=stack)  # f > 4
    with pytest.raises(ValueError):
        C.fold_halfsums(F, stack, 2, r, out=stack)  # size < 4
    with pytest.raises(ValueError):
        C.fold_halfsums(F, stack, 16, r, out=stack[:, :, 4:12])  # overlaps the input


def test_params_words():
    for field in (GOLDILOCKS, BLS12_381_FR):
        w = field_params(field)
        nw = field.n_limbs // 2
        p = sum(int(w[i]) << (32 * i) for i in range(nw))
        assert p == field.p
        assert (int(w[nw]) * field.p) % (1 << 32) == (1 << 32) - 1  # -p^-1 mod 2^32
        two = sum(int(w[nw + 1 + 2 * nw + i]) << (32 * i) for i in range(nw))
        assert two == (2 * field.R) % field.p


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("field", list(TF))
def test_cuda_kernels_match_plain(cuda, field):
    field = TF[field]
    L = field.n_limbs
    stack = interop.limbs_from_numpy(_table(field, (1, L, 1 << 12), 70), cuda)
    rs = interop.limbs_from_numpy(_table(field, (L, 4), 71), cuda)
    for f in range(1, 5):
        got = C.fold_multi(field, stack, 1 << 12, rs[:, :f].contiguous(), out=stack.new_empty((1, L, 1 << (12 - f))))
        want = C.fold_multi_plain(field, stack, 1 << 12, rs[:, :f], stack.new_zeros((1, L, 1 << (12 - f))))
        assert torch.equal(got, want)
    assert torch.equal(C.round_sums(field, 1, stack, 1 << 12), C.round_sums_plain(field, 1, stack, 1 << 12))
    out, acc = C.fold_halfsums(field, stack, 1 << 12, rs[:, :1].contiguous(), out=stack.new_empty((1, L, 1 << 11)))
    want, want_acc = C.fold_halfsums_plain(field, stack, 1 << 12, rs[:, :1], stack.new_zeros((1, L, 1 << 11)))
    assert torch.equal(out, want) and torch.equal(acc, want_acc)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [GOLDILOCKS, BLS12_381_FR, BLS12_377_FR], ids=lambda f: f.name)
def test_cuda_fold_multi_in_place_and_fresh_at_ragged_shapes(cuda, field):
    """f = 1..4 MSB variables, outputs from 1 element to a partial block,
    row strides that are not the size, a fresh buffer and in place."""
    L = field.n_limbs
    for size in (16, 1 << 9, 1 << 13):
        cap = size + 40
        stack = interop.limbs_from_numpy(_table(field, (1, L, cap), size), cuda)
        rs = interop.limbs_from_numpy(_table(field, (L, 4), size + 1), cuda)
        for f in range(1, 5):
            r, n = rs[:, :f].contiguous(), size >> f
            want = C.fold_multi_plain(field, stack, size, r, stack.new_zeros((1, L, n)))
            fresh = C.fold_multi(field, stack, size, r, out=stack.new_zeros((1, L, n + 8)))
            assert torch.equal(fresh[:, :, :n], want) and not fresh[:, :, n:].any()
            inplace = stack.clone()
            C.fold_multi(field, inplace, size, r, out=inplace)
            assert torch.equal(inplace[:, :, :n], want) and torch.equal(inplace[:, :, n:], stack[:, :, n:])
