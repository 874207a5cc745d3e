"""The port's NTT, elementwise field kernels and univariate polynomials
against zk_tpu, exact (integer arithmetic: tolerance 0).

ntt / intt          vs zk_tpu.ntt.ntt / intt (Goldilocks, one JAX
                    compile per length) and zk_tpu.ntt.host_dft, JAX's own
                    exact-int oracle (BLS12-381, BLS12-377, F17: a JAX
                    BLS12-381 NTT compiles for 20-30 s on the CPU)
ntt_ladder          vs zk_tpu.ntt._ladder_body and a level of _rec_axis2
                    (Goldilocks), host_dft (BLS12-381, BLS12-377)
mont_mul / lerp     vs their definitions in host ints
UnivariatePolynomial vs zk_tpu.poly.univariate (pure Python on both sides)

Inputs come from seeded ``random`` or numpy.  On CPU tensors the kernel
wrappers run their plain versions, so these tests drive the same radix
recursion (ladders, twiddle multiply, transposes) that the card runs; the
``cuda`` tests compare the kernels with their plain versions on a card and
skip elsewhere.
"""

import importlib
import random

import numpy as np
import pytest
import torch

from zk_tpu import fields as jfields
from zk_tpu import ntt as jntt
from zk_tpu.fields import device as jdev
from zk_tpu.poly.univariate import UnivariatePolynomial as JUni
from zk_tpu_torch import interop
from zk_tpu_torch.fields import ALL_FIELDS, BLS12_377_FR, BLS12_381_FR, F17, GOLDILOCKS
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields import kernels as FK
from zk_tpu_torch.poly.univariate import UnivariatePolynomial
from torch_helpers import host_ints, lerp_int, mont_limbs, once_per_session

# the module: the package's own ``zk_tpu_torch.ntt`` attribute is the
# exported function ntt
N = importlib.import_module("zk_tpu_torch.ntt")

torch.set_num_threads(1)

# each package gets its own field object of the same name
JF = {f.name: f for f in jfields.ALL_FIELDS}
TF = {f.name: f for f in ALL_FIELDS}
CPU = "cpu"


def _vals(field, n, seed):
    rng = random.Random(seed)
    return [rng.randrange(field.p) for _ in range(n)]


# --------------------------------------------------------------------------
# the transforms against zk_tpu
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1 << 13])
def test_ntt_and_intt_match_jax_goldilocks(n):
    """One JAX compile per length: JAX's forward at 256 (its direct
    ladder), its inverse at 2^13 (its 4-step).  Each checks both of the
    port's directions: JAX's transform is a bijection, so
    jax_intt(port_ntt(x)) == x means port_ntt(x) == jax_ntt(x)."""
    jf, f = JF["Goldilocks"], GOLDILOCKS
    x = _vals(f, n, n)
    y = N.ntt(f, x, device=CPU)
    if n == 256:
        assert y == jntt.ntt(jf, x)
    else:
        assert jntt.intt(jf, y) == x
    assert N.intt(f, y, device=CPU) == x


# JAX's references of the ladder tests, in one jit computed once a session
# (XLA:CPU at its lowest backend optimization level: the integers are the
# same and the compile takes about half the CPU): _ladder_body on (L, 8, 16)
# forward and inverse, and a level of _rec_axis2 (ladders along axis -2,
# twiddle multiply, transpose) at t1 = 8, t2 = 4, B = 3, inverse.  The
# recursion as a whole is held against host_dft below.
BODY = (8, 16)
LEVEL = (8, 4, 3)


def _jax_ladder_references():
    import jax

    jf = JF["Goldilocks"]
    L = jf.n_limbs
    t1, t2, B = LEVEL

    def level(x):
        y = jntt._ladder_axis2(jf, x, *jntt._plan(jf, t1, True))
        tw = jntt._twiddle_table(jf, t2, t1, jntt._twiddle_base_row(jf, t1 * t2, t2, True))  # (L, t1, t2)
        y = jdev.mont_mul(jf, y.reshape(L, t1, t2, B), tw[:, :, :, None])
        return y.transpose(0, 2, 1, 3)  # (L, t2, t1, B)

    def refs(r, x):
        bodies = [jntt._ladder_body(jf, r, *jntt._plan(jf, BODY[1], inverse)) for inverse in (False, True)]
        return (*bodies, level(x))

    r = np.asarray(jdev.encode_ints(jf, _vals(GOLDILOCKS, BODY[0] * BODY[1], 5))).reshape(L, *BODY)
    x = np.asarray(jdev.encode_ints(jf, _vals(GOLDILOCKS, t1 * t2 * B, 31))).reshape(L, t1, t2 * B)
    compiled = jax.jit(refs).lower(r, x).compile(compiler_options={"xla_backend_optimization_level": 0})
    fwd, inv, got_level = compiled(r, x)
    return {"body": [np.asarray(fwd).tolist(), np.asarray(inv).tolist()], "level": np.asarray(got_level).tolist()}


@pytest.fixture(scope="module")
def jax_ladders(tmp_path_factory):
    return once_per_session(tmp_path_factory, "jax_ntt_ladder_references", _jax_ladder_references)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_ladder_plain_matches_jax_ladder_body(jax_ladders, inverse):
    """The row ladder against JAX's _ladder_body (last axis), and the
    ladder pass (CPU wrapper = plain version) against _ladder_axis2 (axis -2)."""
    f = GOLDILOCKS
    x = dev.encode_ints(f, _vals(f, BODY[0] * BODY[1], 5), device=CPU).reshape(f.n_limbs, *BODY)
    want = np.asarray(jax_ladders["body"][int(inverse)], dtype=np.uint32)
    got = N.ladder_rows_plain(f, x, inverse)
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), want)
    cols = x.transpose(1, 2).contiguous()  # (L, 16, 8)
    assert torch.equal(N.ntt_ladder(f, cols, inverse), got.transpose(1, 2))
    assert torch.equal(N.ntt_ladder_plain(f, cols, inverse), got.transpose(1, 2))


def test_level_pass_matches_jax_rec_axis2_level(jax_ladders):
    """One upper level, inverse: ladders along axis -2 with the t1^-1
    scale, the twiddles w_T^(-k1 i2), the transposed (L, t2, t1, B) store."""
    f = GOLDILOCKS
    t1, t2, B = LEVEL
    x = dev.encode_ints(f, _vals(f, t1 * t2 * B, 31), device=CPU).reshape(f.n_limbs, t1, t2 * B)
    got = N.ntt_ladder(f, x, inverse=True, batch=B)
    assert got.shape == (f.n_limbs, t2, t1, B)
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), np.asarray(jax_ladders["level"], dtype=np.uint32))


def _level_host(field, cols: list[list[int]], t1: int, B: int | None, inverse: bool) -> list[list[int]]:
    """The ladder pass in host ints: the DFT of every column (JAX's
    host_dft), then for an upper level the twiddle w_T^(k1 i2) and the
    [i2, k1, b] order.  cols[c] is column c; returns rows of the output
    flattened over its last axes."""
    jf = JF[field.name]
    ys = [jntt.host_dft(jf, c, inverse) for c in cols]
    if B is None:
        return [[ys[c][k1] for c in range(len(cols))] for k1 in range(t1)]
    t2 = len(cols) // B
    w = field.get_root_of_unity(t1 * t2)
    w = field.inv(w) if inverse else w
    return [[ys[i2 * B + b][k1] * pow(w, k1 * i2, field.p) % field.p for k1 in range(t1) for b in range(B)]
            for i2 in range(t2)]


@pytest.mark.parametrize("field", ["BLS12-381-Fr", "BLS12-377-Fr"])
@pytest.mark.parametrize("t1,m,batch", [(8, 8, 2), (2, 6, 3), (16, 3, None)])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_level_pass_matches_host_dft(field, t1, m, batch, inverse):
    f = TF[field]
    vals = _vals(f, t1 * m, 7 * t1 + m)
    x = dev.encode_ints(f, vals, device=CPU).reshape(f.n_limbs, t1, m)
    got = N.ntt_ladder(f, x, inverse=inverse, batch=batch)
    cols = [[vals[i1 * m + c] for i1 in range(t1)] for c in range(m)]
    want = _level_host(f, cols, t1, batch, inverse)
    assert [dev.decode_ints(f, row) for row in got.reshape(f.n_limbs, len(want), -1).unbind(1)] == want


def test_kernel_twiddles_are_the_plain_table_in_words():
    """The kernel's element-major level twiddles: the plain table's
    w^(k1 i2) as 32-bit words, times t1^-1 for the inverse."""
    f = BLS12_381_FR
    T, t1 = 32, 8
    w = f.get_root_of_unity(T)
    for inverse, omega in ((False, w), (True, f.inv(w))):
        words = N._kernel_twiddles(f, T, t1, omega, inverse, torch.device(CPU))
        assert words.shape == (T, f.n_limbs // 2) and words.dtype == torch.int32
        limbs = torch.stack([words.t() & 0xFFFF, (words.t() >> 16) & 0xFFFF], dim=1).reshape(f.n_limbs, T)
        scale = f.inv(t1) if inverse else 1
        want = [pow(omega, i2 * k1, f.p) * scale % f.p for i2 in range(T // t1) for k1 in range(t1)]
        assert dev.decode_ints(f, limbs) == want
    assert [N._tile_log_cols(g, t1, m) for g, t1, m in
            ((f, 1024, 1 << 10), (GOLDILOCKS, 1024, 1 << 10), (f, 16, 3), (f, 1024, 1))] == [2, 3, 2, 0]


HOST_DFT_CASES = [("BLS12-381-Fr", 2), ("BLS12-381-Fr", 16), ("BLS12-381-Fr", 64), ("BLS12-377-Fr", 8),
                  ("BLS12-377-Fr", 64), ("F17", 2), ("F17", 16), ("Goldilocks", 32)]


@pytest.mark.parametrize("field,n", HOST_DFT_CASES)
def test_ntt_matches_host_dft(field, n):
    jf, f = JF[field], TF[field]
    x = _vals(f, n, 42 + n)
    assert N.ntt(f, x, device=CPU) == jntt.host_dft(jf, x)
    assert N.intt(f, x, device=CPU) == jntt.host_dft(jf, x, inverse=True)
    assert N.host_dft(f, x) == jntt.host_dft(jf, x)


@pytest.mark.parametrize("field,radix,n", [("Goldilocks", 8, 1 << 9), ("BLS12-381-Fr", 4, 64), ("BLS12-377-Fr", 4, 64)])
def test_multi_level_recursion_matches_host_dft(monkeypatch, field, radix, n):
    """With the radix cut, n splits over three or more levels (ladders,
    twiddle tables with a batch, transposes), forward and inverse."""
    monkeypatch.setattr(N, "RADIX", radix)
    jf, f = JF[field], TF[field]
    x = _vals(f, n, 9)
    y = N.ntt(f, x, device=CPU)
    assert y == jntt.host_dft(jf, x)
    assert N.intt(f, x, device=CPU) == jntt.host_dft(jf, x, inverse=True)
    assert N.intt(f, y, device=CPU) == x


def test_device_transforms_on_limbs_and_one_point():
    f = BLS12_381_FR
    x = _vals(f, 32, 3)
    data = dev.encode_ints(f, x, device=CPU)
    y = N.ntt_device(f, data)
    assert y.shape == data.shape and y.dtype == torch.int32
    assert dev.decode_ints(f, y) == N.host_dft(f, x)
    assert torch.equal(N.intt_device(f, y), data)
    one = dev.encode_ints(f, [7], device=CPU)
    assert N.ntt_device(f, one) is one and N.intt_device(f, one) is one


# --------------------------------------------------------------------------
# published anchors (tests/test_goldens.py)
# --------------------------------------------------------------------------

_ROOT_BLS12_381 = 10238227357739495823651030575849232062558860180284477541189508159991286009131
_ROOT_BLS12_377 = 8065159656716812877374967518403273466521432693661810619979959746626482506078
_ROOT_GOLDILOCKS = 0x185629DCDA58878C


def test_two_adic_roots_are_the_published_literals():
    for f, s, lit in ((BLS12_381_FR, 32, _ROOT_BLS12_381), (BLS12_377_FR, 47, _ROOT_BLS12_377),
                      (GOLDILOCKS, 32, _ROOT_GOLDILOCKS)):
        assert f.two_adicity == s and f.two_adic_root == lit
        assert f.get_root_of_unity(1 << s) == lit
        w = f.get_root_of_unity(1 << 10)
        assert pow(w, 1 << 10, f.p) == 1 and pow(w, 1 << 9, f.p) != 1
        assert f.get_root_of_unity(1 << 9) == (w * w) % f.p
    for f in ALL_FIELDS:
        jf = JF[f.name]
        assert (f.generator, f.two_adicity, f.two_adic_root) == (jf.generator, jf.two_adicity, jf.two_adic_root)
    with pytest.raises(ValueError, match="2-adicity"):
        F17.get_root_of_unity(32)
    with pytest.raises(ValueError, match="power of two"):
        GOLDILOCKS.get_root_of_unity(12)


def test_f17_vector():
    """F17, n = 4, omega = 13: [1, 2, 3, 4] -> [10, 6, 15, 7] (by hand)."""
    assert F17.get_root_of_unity(4) == 13
    assert N.ntt(F17, [1, 2, 3, 4], device=CPU) == [10, 6, 15, 7]
    assert N.intt(F17, [10, 6, 15, 7], device=CPU) == [1, 2, 3, 4]


def test_goldilocks_order_2_and_4_vectors():
    p = 0xFFFFFFFF00000001
    assert GOLDILOCKS.get_root_of_unity(2) == p - 1
    a, b = 123456789, 987654321098765432
    assert N.ntt(GOLDILOCKS, [a, b], device=CPU) == [(a + b) % p, (a - b) % p]
    w4 = pow(_ROOT_GOLDILOCKS, 1 << 30, p)
    assert GOLDILOCKS.get_root_of_unity(4) == w4
    vec = [5, 6, 7, 8]
    assert N.ntt(GOLDILOCKS, vec, device=CPU) == [sum(v * pow(w4, i * j, p) for j, v in enumerate(vec)) % p for i in range(4)]


def test_reference_roundtrip_bls377():
    """fft/src/lib.rs:79-82: a = [0, 2, 34, 3434]."""
    a = [0, 2, 34, 3434]
    assert N.intt(BLS12_377_FR, N.ntt(BLS12_377_FR, a, device=CPU), device=CPU) == a
    assert N.fft is N.ntt and N.ifft is N.intt


def test_ntt_with_root_parity_and_errors():
    f = F17
    vals = [1, 5, 3, 2]
    w = f.get_root_of_unity(4)
    assert N.ntt_with_root(f, vals, w, device=CPU) == N.ntt(f, vals, device=CPU)
    evals = N.ntt(f, vals, device=CPU)
    back = [f.mul(v, f.inv(4)) for v in N.ntt_with_root(f, evals, f.inv(w), device=CPU)]
    assert back == vals
    with pytest.raises(ValueError, match="primitive"):
        N.ntt_with_root(f, vals, 2, device=CPU)  # 2 is not a primitive 4th root mod 17
    # a root other than the field's, through the recursion: w^3 permutes the outputs
    g = GOLDILOCKS
    x = _vals(g, 64, 11)
    w3 = pow(g.get_root_of_unity(64), 3, g.p)
    std = N.host_dft(g, x)
    assert N.ntt_with_root(g, x, w3, device=CPU) == [std[3 * k % 64] for k in range(64)]
    with pytest.raises(ValueError, match="power of 2"):
        N.ntt_with_root(g, x[:3], w3, device=CPU)
    assert N.ntt_with_root(g, [g.p + 4], w3, device=CPU) == [4]


def test_non_power_of_two_and_size_one():
    with pytest.raises(ValueError, match="power of 2"):
        N.ntt(F17, [1, 2, 3], device=CPU)
    with pytest.raises(ValueError, match="power of 2"):
        N.intt_device(GOLDILOCKS, dev.encode_ints(GOLDILOCKS, [1, 2, 3], device=CPU))
    assert N.ntt(F17, [5]) == [5] and N.intt(F17, [22]) == [5]  # no device touched


def test_ladder_checks_its_input():
    f = GOLDILOCKS
    x = torch.zeros((f.n_limbs, 2, 16), dtype=torch.int32)
    with pytest.raises(ValueError):
        N.ntt_ladder(f, x[:, :, :12], False)  # not a power of two
    with pytest.raises(ValueError):
        N.ntt_ladder(f, torch.zeros((f.n_limbs, 1, 2 * N.LADDER_MAX), dtype=torch.int32))
    with pytest.raises(ValueError):
        N.ntt_ladder(f, x.long())
    with pytest.raises(ValueError):
        N.ntt_ladder(BLS12_381_FR, x)  # 4 limbs for a 16-limb field


# --------------------------------------------------------------------------
# elementwise wrappers on CPU tensors
# --------------------------------------------------------------------------


def _rand_limbs(field, n, seed):
    return mont_limbs(field, _vals(field, n, seed))


@pytest.mark.parametrize("field", ["F17", "Goldilocks", "BLS12-381-Fr"])
def test_mont_mul_and_lerp_against_host_ints(field):
    f = TF[field]
    a, b = _rand_limbs(f, 37, 1), _rand_limbs(f, 37, 2)
    ta, tb = interop.limbs_from_numpy(a, CPU), interop.limbs_from_numpy(b, CPU)
    r_int = 0x0123456789ABCDEF % f.p
    r = dev.scalar(f, r_int, device=CPU)
    xa, xb = host_ints(f, a), host_ints(f, b)
    got = FK.mont_mul(f, ta, tb)
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), mont_limbs(f, [u * v for u, v in zip(xa, xb)]))
    got = FK.lerp(f, ta, tb, r)
    np.testing.assert_array_equal(interop.limbs_to_numpy(got), mont_limbs(f, [lerp_int(f, u, v, r_int) for u, v in zip(xa, xb)]))
    assert torch.equal(FK.lerp(f, ta, tb, r.reshape(-1)), got)  # an (L,) scalar too
    assert torch.equal(FK.mont_mul_plain(f, ta, tb), FK.mont_mul(f, ta, tb))
    assert torch.equal(FK.lerp_plain(f, ta, tb, r), got)


def test_elementwise_wrappers_reject_what_the_kernels_do_not_take():
    f = GOLDILOCKS
    a = torch.zeros((f.n_limbs, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        FK.mont_mul(f, a, a[:, :4])  # mismatched shapes (jnp broadcasts there)
    with pytest.raises(ValueError):
        FK.mont_mul(f, a.reshape(f.n_limbs, 2, 4), a.reshape(f.n_limbs, 2, 4))  # not (L, N)
    with pytest.raises(TypeError):
        FK.mont_mul(f, a.long(), a.long())
    with pytest.raises(ValueError):
        FK.lerp(f, a, a, torch.zeros((f.n_limbs, 2), dtype=torch.int32))  # r is not one scalar


# --------------------------------------------------------------------------
# UnivariatePolynomial against zk_tpu's (pure Python on both sides)
# --------------------------------------------------------------------------


@pytest.fixture
def ntt_on_cpu(monkeypatch):
    """Route __mul__'s NTT products to CPU tensors, and count them."""
    calls = []
    orig = UnivariatePolynomial._mul_ntt

    def on_cpu(self, other, n, out_len, device=None):
        calls.append(n)
        return orig(self, other, n, out_len, device=CPU)

    monkeypatch.setattr(UnivariatePolynomial, "_mul_ntt", on_cpu)
    return calls


@pytest.mark.parametrize("field,la,lb", [("BLS12-381-Fr", 200, 150), ("Goldilocks", 256, 256), ("BLS12-377-Fr", 129, 128)])
def test_mul_through_the_ntt_matches_jax_schoolbook(ntt_on_cpu, field, la, lb):
    jf, f = JF[field], TF[field]
    a, b = _vals(f, la, 7), _vals(f, lb, 8)
    got = UnivariatePolynomial(f, a) * UnivariatePolynomial(f, b)
    assert ntt_on_cpu == [1 << (la + lb - 2).bit_length()]
    assert got.coefficients == JUni(jf, a)._mul_schoolbook(JUni(jf, b)).coefficients
    assert got.degree() == la + lb - 2


def test_mul_ntt_takes_a_device():
    f = BLS12_381_FR
    a, b = UnivariatePolynomial(f, _vals(f, 100, 1)), UnivariatePolynomial(f, _vals(f, 60, 2))
    assert a._mul_ntt(b, 256, 159, device=CPU) == a._mul_schoolbook(b)


def test_small_products_and_interpolation_match_jax(ntt_on_cpu):
    jf, f = JF["F17"], F17
    assert (UnivariatePolynomial(f, [4, 3, 2]) * UnivariatePolynomial(f, [3, 4, 0, 4])).coefficients == [12, 8, 1, 7, 12, 8]
    x255 = UnivariatePolynomial(GOLDILOCKS, [0] * 255 + [1])
    assert (x255 * x255).coefficients == [0] * 510 + [1]  # out_len 511, NTT length 512
    assert ntt_on_cpu == [512]
    for xs, ys in (([0, 1, 3, 4, 5, 8], [12, 48, 3150, 11772, 33452, 315020]), ([5, 7, 9, 1], [565, 1631, 3537, -7])):
        got = UnivariatePolynomial.interpolate_xy(f, xs, ys)
        assert got.coefficients == JUni.interpolate_xy(jf, xs, ys).coefficients
    fr, jfr = BLS12_381_FR, JF["BLS12-381-Fr"]
    ys = _vals(fr, 5, 4)
    assert UnivariatePolynomial.interpolate(fr, ys).coefficients == JUni.interpolate(jfr, ys).coefficients
    assert UnivariatePolynomial.interpolate_xy(fr, range(5), ys) == UnivariatePolynomial.interpolate(fr, ys)


def test_add_bytes_identities_and_trait_methods_match_jax():
    jf, f = JF["BLS12-381-Fr"], BLS12_381_FR
    a, b = _vals(f, 7, 1), _vals(f, 4, 2)
    pa, pb = UnivariatePolynomial(f, a), UnivariatePolynomial(f, b)
    assert (pa + pb).coefficients == (JUni(jf, a) + JUni(jf, b)).coefficients
    assert pb + pa == pa + pb
    assert pa.to_bytes() == JUni(jf, a).to_bytes()
    zero, one = UnivariatePolynomial.additive_identity(f), UnivariatePolynomial.multiplicative_identity(f)
    assert zero.is_zero() and zero.degree() == 0 and pa + zero == pa and pa * one == pa and (pa * zero).is_zero()
    p = UnivariatePolynomial.interpolate_xy(F17, [5, 7, 9, 1], [565, 1631, 3537, -7])
    assert p.n_vars() == 1 and p.relabel() is p and p.to_univariate() == p
    assert p.evaluate_slice([5]) == 565 % 17
    assert p.partial_evaluate_selectors([([True], 5)]) == UnivariatePolynomial(F17, [565])
    assert p.partial_evaluate_selectors([([False], 3)]) == p
    for bad in (lambda: p.evaluate_slice([]), lambda: p.partial_evaluate_selectors([([True], 1), ([True], 2)]),
                lambda: p.partial_evaluate_selectors([([True, False], 1)])):
        with pytest.raises(ValueError):
            bad()


# --------------------------------------------------------------------------
# on the card only
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["Goldilocks", "BLS12-381-Fr"])
def test_cuda_transforms_match_plain_route(cuda, monkeypatch, field):
    """The kernel route of a multi-level transform equals the plain route
    (the same recursion on CPU tensors), and roundtrips."""
    monkeypatch.setattr(N, "RADIX", 16)
    f = TF[field]
    x = _vals(f, 1 << 10, 21)
    assert N.ntt(f, x, device=cuda) == N.ntt(f, x, device=CPU)
    assert N.intt(f, N.ntt(f, x, device=cuda), device=cuda) == x
    a = UnivariatePolynomial(f, x[:300])
    assert a._mul_ntt(a, 1024, 599, device=cuda) == a._mul_ntt(a, 1024, 599, device=CPU)


def _rand_limbs_on(field, shape, gen, device):
    """Random valid Montgomery limbs (< p) of shape (L, ...) on a device."""
    t = torch.randint(0, 1 << 16, shape, generator=gen, dtype=torch.int32)
    top = (field.p >> (16 * (field.n_limbs - 1))).bit_length() - 1
    t[field.n_limbs - 1] &= (1 << top) - 1
    return t.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("field", ["Goldilocks", "BLS12-381-Fr", "BLS12-377-Fr"])
def test_cuda_ladder_pass_matches_plain_at_ragged_shapes(cuda, field):
    """The kernel against its plain version on the card: n_t = 2 .. 1024,
    column counts that leave a partial tile, the last level and upper
    levels (fused twiddles, transposed store), forward and inverse."""
    f = TF[field]
    gen = torch.Generator().manual_seed(5)
    for t1 in (2, 4, 16, 128, 1024):
        for m, batch in ((1, None), (3, None), (37, None), (12, 3), (32, 1), (24, 3), (6, 6)):
            x = _rand_limbs_on(f, (f.n_limbs, t1, m), gen, cuda)
            for inverse in (False, True):
                got = N.ntt_ladder(f, x, inverse, batch=batch)
                assert torch.equal(got, N.ntt_ladder_plain(f, x, inverse, batch=batch)), (t1, m, batch, inverse)
