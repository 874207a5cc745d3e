"""The port's host-tier surface against zk_tpu's, exact: the coefficient-form
MLE, the pairing index, the Boolean hypercube, the Field conversions,
keccak256, Circuit.outputs, and the MLE, ProductPoly and SumOfProducts
methods.

Each scenario runs the same seeded inputs through both packages (each with
its own field objects) and compares the results.  The scenarios mirror
tests/test_coeff_mle.py and tests/test_mle.py.  The
host-int scenarios run in every field; the tensor methods run over F17,
Goldilocks and BLS12-381, with zk_tpu's side (its jnp ops) computed once
per session and field.  Property cases at sizes past the scenarios' hold
both packages against brute force: the pairing index, the hypercube order,
interpolation, and Keccak-256 at the sponge's block boundaries.
"""

import functools
import json
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import zk_tpu.fields as jfields
import zk_tpu.gkr.circuit as jcircuit
import zk_tpu.poly as jpoly
import zk_tpu.poly.coeff_mle as jcm
import zk_tpu.poly.hypercube as jhc
import zk_tpu.poly.pairing_index as jpi
import zk_tpu.transcript.keccak as jkeccak
import zk_tpu_torch.fields as tfields
import zk_tpu_torch.gkr.circuit as tcircuit
import zk_tpu_torch.poly.coeff_mle as tcm
import zk_tpu_torch.poly.hypercube as thc
import zk_tpu_torch.poly.pairing_index as tpi
import zk_tpu_torch.transcript.keccak as tkeccak
from zk_tpu_torch.poly.mle import MLE
from zk_tpu_torch.poly.product import ProductPoly, SumOfProducts
from zk_tpu_torch.poly.univariate import UnivariatePolynomial

from torch_helpers import once_per_session

torch.set_num_threads(1)


def _ns(fields, cm, hc, pi, keccak, circuit) -> SimpleNamespace:
    return SimpleNamespace(
        F17=fields.F17, G=fields.GOLDILOCKS, FR=fields.BLS12_381_FR, cm=cm, CM=cm.CoeffMultilinearPolynomial,
        hc=hc, pi=pi, keccak256=keccak.keccak256, Circuit=circuit.Circuit, Gate=circuit.Gate,
    )


JAX = _ns(jfields, jcm, jhc, jpi, jkeccak, jcircuit)
PORT = _ns(tfields, tcm, thc, tpi, tkeccak, tcircuit)


def _plain(x):
    """A result as plain data: polynomials by their values, errors by type
    and message."""
    if isinstance(x, (jcm.CoeffMultilinearPolynomial, tcm.CoeffMultilinearPolynomial)):
        return ("CM", x.n_vars, sorted(x.coefficients.items()))
    if isinstance(x, (jpoly.UnivariatePolynomial, UnivariatePolynomial)):
        return ("U", x.coefficients)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _run(fn, ns):
    try:
        return _plain(fn(ns))
    except (ValueError, ZeroDivisionError, IndexError) as e:
        return ("raises", type(e).__name__, str(e))


# --------------------------------------------------------------------------
# host-int scenarios (coefficient_form.rs, pairing_index.rs,
# boolean_hypercube.rs, the Field, Keccak-256, Circuit)
# --------------------------------------------------------------------------


def _p5ab_7bc_8d(ns):
    return ns.CM.new(ns.F17, 4, [
        (5, [True, True, False, False]), (7, [False, True, True, False]), (8, [False, False, False, True]),
    ])


def _random_cm(ns, field, n, seed, terms=6):
    rng = random.Random(seed)
    return ns.CM.new(field, n, [
        (rng.randrange(field.p), [rng.random() < 0.5 for _ in range(n)]) for _ in range(terms)
    ])


def _sel(n, i):
    return [j == i for j in range(n)]


HOST = {
    "instantiation": lambda ns: [
        ns.CM.new(ns.F17, 2, [(2, [True, True])]),
        ns.CM.new(ns.F17, 2, [(2, [True, False]), (3, [False, True]), (5, [True, True])]),
        ns.CM.new(ns.F17, 2, [(5, [False, False])]),
        ns.CM.new(ns.F17, 2, [(2, [True, True]), (3, [True, True]), (4, [False, True])]),
    ],
    "instantiation_invalid": lambda ns: ns.CM.new(ns.F17, 3, [(2, [True, True])]),
    "new_with_coefficient_invalid": lambda ns: ns.CM.new_with_coefficient(ns.F17, 2, {4: 1}),
    "selectors": lambda ns: [
        [ns.cm.selector_to_index(s) for s in ([False] * 4, _sel(4, 0), _sel(4, 1), [True, True, False, True])],
        [ns.cm.selector_from_usize(v, w) for v, w in ((0, 3), (5, 3), (11, 6), (13, 2))],
        [ns.cm.selector_from_position(4, p) for p in range(4)],
        [ns.cm.bit_count_for_n_elem(s) for s in (1, 2, 3, 4, 5, 8, 9, 1024, 1025)],
        [ns.cm.mapping_instruction_from_variable_presence(v) for v in (
            [True, False, False, True], [True, False, False, True, True], [False, False, True, True],
            [True, True], [False, False])],
        ns.cm._to_power_of_two(ns.cm.mapping_instruction_from_variable_presence(
            [False, True, False, False, True, False])),
    ],
    "selector_position_out_of_bounds": lambda ns: ns.cm.selector_from_position(3, 3),
    "get_variable_indexes": lambda ns: [ns.CM.get_variable_indexes(4, _sel(4, i)) for i in range(4)],
    "get_variable_indexes_constant": lambda ns: ns.CM.get_variable_indexes(4, [False] * 4),
    "get_variable_indexes_two": lambda ns: ns.CM.get_variable_indexes(4, [True, False, True, False]),
    "partial_evaluate": lambda ns: [
        _p5ab_7bc_8d(ns).partial_evaluate([]),
        _p5ab_7bc_8d(ns).partial_evaluate([(_sel(4, 1), 3), (_sel(4, 0), 2)]),
        _p5ab_7bc_8d(ns).partial_evaluate([(_sel(4, 1), 3), (_sel(4, 0), 2), (_sel(4, 2), 2)]),
        _p5ab_7bc_8d(ns).partial_evaluate([(_sel(4, 0), 2), (_sel(4, 1), 4), (_sel(4, 2), 3), (_sel(4, 3), 5)]),
        _p5ab_7bc_8d(ns).partial_evaluate([(_sel(4, 0), 2), (_sel(4, 0), 3), (_sel(4, 1), 4), (_sel(4, 3), 5)]),
        _p5ab_7bc_8d(ns).partial_evaluate([([True, False, False, False, False], 3)]),
    ],
    "evaluate_slice": lambda ns: [
        _p5ab_7bc_8d(ns).evaluate_slice([2, 4, 3, 5]),
        _p5ab_7bc_8d(ns).evaluate_slice([2, 4, 3, 5, 8]),
        ns.CM.additive_identity(ns.F17).evaluate_slice([]),
    ],
    "evaluate_incomplete": lambda ns: _p5ab_7bc_8d(ns).evaluate_slice([4]),
    "algebra": lambda ns: [
        _p5ab_7bc_8d(ns) + _p5ab_7bc_8d(ns),
        _p5ab_7bc_8d(ns).scalar_multiply(2),
        _p5ab_7bc_8d(ns) * ns.CM.new(ns.F17, 0, [(2, [])]),
        ns.CM.new(ns.F17, 2, [(5, [True, True])]) * ns.CM.new(ns.F17, 1, [(6, [True])]),
        ns.CM.new(ns.F17, 3, [(3, [True, False, True]), (2, [True, True, False])])
        * ns.CM.new(ns.F17, 2, [(7, [True, True])]),
        ns.CM.new(ns.F17, 4, [(2, _sel(4, 0)), (3, [False, True, True, False]), (6, _sel(4, 3))])
        * ns.CM.new(ns.F17, 4, [(4, _sel(4, 0)), (5, [False, True, True, False]), (2, _sel(4, 3))]),
        (ns.CM.new(ns.F17, 2, [(2, [True, False]), (3, [False, True])]) * ns.CM.new(ns.F17, 1, [(4, [True])]))
        * ns.CM.new(ns.F17, 1, [(5, [True])]),
        _p5ab_7bc_8d(ns) * ns.CM.multiplicative_identity(ns.F17),
        _p5ab_7bc_8d(ns) + ns.CM.additive_identity(ns.F17),
        _p5ab_7bc_8d(ns) * ns.CM.multiplicative_identity(ns.F17) == _p5ab_7bc_8d(ns),
        _p5ab_7bc_8d(ns) == _p5ab_7bc_8d(ns).scalar_multiply(2),
    ],
    "checkers": lambda ns: [
        [ns.CM.check_zero(ns.F17).evaluate_slice([x]) for x in (0, 1, 5)],
        [ns.CM.check_one(ns.F17).evaluate_slice([x]) for x in (0, 1, 20)],
        [ns.CM.lagrange_basis_poly(ns.F17, 5, 3).evaluate_slice(pt) for pt in ns.hc.BooleanHyperCube(3)],
        [ns.CM.bit_string_checker(ns.F17, "001").evaluate_slice(pt) for pt in ns.hc.BooleanHyperCube(3)],
        ns.CM.interpolate(ns.F17, [2, 4, 8, 3]),
        ns.CM.interpolate(ns.F17, []),
    ],
    "relabel": lambda ns: [
        _p5ab_7bc_8d(ns).variable_presence_vector(),
        ns.CM.new(ns.F17, 3, [(3, [True, False, False]), (2, [False, False, True])]).variable_presence_vector(),
        ns.CM.new(ns.F17, 4, [
            (2, [True, True, False, False]), (3, [False, False, True, True]),
            (5, [True, False, True, True]), (6, [False, True, False, True]),
        ]).partial_evaluate([(_sel(4, 1), 1), (_sel(4, 2), 1)]).relabel(),
        ns.CM.multiplicative_identity(ns.F17).relabel(),
        ns.cm._remap_coefficient_keys(4, _p5ab_7bc_8d(ns), [(3, 0)]),
    ],
    "conversions": lambda ns: [
        ns.CM.new(ns.F17, 1, [(2, [True])]).to_univariate(),
        ns.CM.new(ns.F17, 1, [(3, [True]), (4, [False])]).to_univariate(),
        ns.CM.additive_identity(ns.F17).to_univariate(),
        ns.CM.new(ns.F17, 3, [(2, [True, True, False]), (3, [False, True, True])]).to_evaluation_form(),
        ns.CM.new(ns.F17, 2, [(2, [True, False]), (3, [False, True])]).to_bytes(),
    ],
    "to_univariate_too_many_vars": lambda ns: _p5ab_7bc_8d(ns).to_univariate(),
    "pairing_index": lambda ns: [
        [ns.pi.insert_bit(v, i, b) for v, i, b in ((0b10101, 0, 0), (0b10101, 0, 1), (0b10101, 5, 0),
                                                   (0b10101, 5, 1), (0b10, 1, 0), (0b10, 1, 1))],
        [ns.pi.mask(n) for n in range(5)],
        [list(ns.pi.index_pair(n, i)) for n in range(1, 5) for i in range(n)],
    ],
    "boolean_hypercube": lambda ns: [list(ns.hc.BooleanHyperCube(n)) for n in range(5)],
}


def _random_cases(field_name):
    def case(ns):
        f = getattr(ns, field_name)
        rng = random.Random(19)
        a, b = _random_cm(ns, f, 4, 20), _random_cm(ns, f, 3, 21)
        vals = [rng.randrange(f.p) for _ in range(8)]
        pt = [rng.randrange(f.p) for _ in range(7)]
        return [
            a, a + a, a * b, (a * b).evaluate_slice(pt), a.partial_evaluate([(_sel(4, 2), pt[0])]).relabel(),
            ns.CM.interpolate(f, vals), ns.CM.interpolate(f, vals).to_evaluation_form(), a.to_bytes(),
            a.to_evaluation_form(),
        ]
    return case


def _field_conversions(field_name):
    def case(ns):
        f = getattr(ns, field_name)
        rng = random.Random(23)
        xs = [0, 1, f.p - 1, f.p, -1, -f.p - 5, 3 * f.p + 7] + [rng.randrange(-f.p, 2 * f.p) for _ in range(8)]
        return [
            [f.from_int(x) for x in xs], [f.to_limbs(x) for x in xs],
            [f.from_limbs(f.to_limbs(x)) for x in xs], [f.from_limbs([0xFFFF] * f.n_limbs)],
            [f.to_mont(x) for x in xs], [f.from_mont(x) for x in xs], [f.from_mont(f.to_mont(x)) for x in xs],
        ]
    return case


def _keccak(ns):
    rng = random.Random(29)
    msgs = [b"", b"abc", bytes(135), bytes(136), bytes(137), bytes(rng.randrange(256) for _ in range(1000))]
    return [ns.keccak256(m).hex() for m in msgs]


def _circuit_outputs(field_name):
    def case(ns):
        f = getattr(ns, field_name)
        rng = random.Random(31)
        layers, below = [], 12
        for width in (16, 16, 5):
            layers.append([ns.Gate("add" if rng.random() < 0.5 else "mul", rng.randrange(below),
                                   rng.randrange(below)) for _ in range(width)])
            below = width
        layers.reverse()
        inputs = [rng.randrange(f.p) for _ in range(12)]
        return ns.Circuit(layers, n_inputs=12).outputs(f, inputs)
    return case


for _f in ("F17", "G", "FR"):
    HOST[f"random_{_f}"] = _random_cases(_f)
    HOST[f"field_conversions_{_f}"] = _field_conversions(_f)
    HOST[f"circuit_outputs_{_f}"] = _circuit_outputs(_f)
HOST["keccak256"] = _keccak


@pytest.mark.parametrize("scenario", list(HOST))
def test_host_tier_matches_zk_tpu(scenario):
    want = _run(HOST[scenario], JAX)
    assert _run(HOST[scenario], PORT) == want


def test_index_pairs_match_brute_force():
    """Each variable's pairs, variable 0 the most significant bit: every
    index once, ascending, the pair differing in that variable alone."""
    for n in range(1, 9):
        for i in range(n):
            bit = 1 << (n - 1 - i)
            want = [(j, j | bit) for j in range(1 << n) if not j & bit]
            assert list(tpi.index_pair(n, i)) == want == list(jpi.index_pair(n, i))


def test_boolean_hypercube_order():
    """2^n points in index order, variable 0 the most significant bit (no
    point at all for n = 0, as in the reference)."""
    for n in range(9):
        want = [[j >> (n - 1 - i) & 1 for i in range(n)] for j in range(1 << n)] if n else []
        assert list(thc.BooleanHyperCube(n)) == want == list(jhc.BooleanHyperCube(n))


@pytest.mark.parametrize("field_name", ["F17", "G", "FR"])
def test_interpolate_inverts_evaluation_form(field_name):
    """interpolate then to_evaluation_form gives the values back for 1 to 4
    variables, and both packages build the same coefficients."""
    def case(ns):
        f = getattr(ns, field_name)
        rng = random.Random(41)
        polys = []
        for n in range(1, 5):
            vals = [rng.randrange(f.p) for _ in range(1 << n)]
            polys.append(ns.CM.interpolate(f, vals))
            assert polys[-1].to_evaluation_form() == vals
        return polys

    assert _run(case, PORT) == _run(case, JAX)


@pytest.mark.parametrize("length", [1, 135, 136, 137, 272, 408, 4096])
def test_keccak256_block_boundaries_match_zk_tpu(length):
    """One byte; a message ending before, on and after the first 136-byte
    block; the ends of the second and third blocks; a long message."""
    msg = bytes(random.Random(length).randrange(256) for _ in range(length))
    assert tkeccak.keccak256(msg) == jkeccak.keccak256(msg)


def test_keccak256_known_answer():
    assert tkeccak.keccak256(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"


# --------------------------------------------------------------------------
# tensor methods (every field but BLS12-377): MLE.from_coeff / __eq__,
# ProductPoly and SumOfProducts
# --------------------------------------------------------------------------

TENSOR_FIELDS = ("F17", "Goldilocks", "BLS12-381-Fr")


def _tensor_results(MLE_, PP, SOP, field, CM, to_ints, to_limbs) -> dict:
    rng = random.Random(37)
    a, b, c = ([rng.randrange(field.p) for _ in range(8)] for _ in range(3))
    ma, mb, mc = (MLE_.new(field, 3, v) for v in (a, b, c))
    pp = PP([ma, mb])
    sop = SOP([PP([ma, mb]), PP([mc])])
    r = rng.randrange(field.p)
    coeff = CM.new(field, 3, [(5, [True, True, False]), (rng.randrange(field.p), [False, True, True]), (7, [False] * 3)])
    return {
        "from_coeff": to_ints(MLE_.from_coeff(coeff).data),
        "mle_eq": [ma == MLE_.new(field, 3, a), ma == mb, ma == MLE_.new(field, 2, a[:4]), ma == "x"],
        # one fold shape (n = 3, variable 1, one assignment): one JAX compile
        "product_partial_evaluate": [to_ints(m.data) for m in pp.partial_evaluate(1, [r]).polynomials],
        "product_prod_reduce": [to_ints(pp.prod_reduce()), pp.prod_reduce_ints()],
        "product_stacked": to_limbs(pp.stacked()),
        "product_eq": [pp == PP([ma, mb]), pp == PP([mb, ma]), pp == PP([ma]),
                       pp.partial_evaluate(1, [r]) == PP([ma.partial_evaluate(1, [r]), mb.partial_evaluate(1, [r])])],
        "sum_of_products": [
            [[to_ints(m.data) for m in t.polynomials] for t in sop.partial_evaluate(1, [r]).terms],
            to_ints(sop.sum_reduce()),
        ],
    }


def _field(fields, name):
    return next(f for f in fields.ALL_FIELDS if f.name == name)


def _jax_tensor_results(name: str) -> dict:
    from zk_tpu.fields import device as jdev

    f = _field(jfields, name)
    return _tensor_results(
        jpoly.MLE, jpoly.ProductPoly, jpoly.SumOfProducts, f, jcm.CoeffMultilinearPolynomial,
        lambda t: jdev.decode_ints(f, t), lambda t: np.asarray(t).tolist(),
    )


@functools.lru_cache(maxsize=None)
def _port_tensor_results(name: str) -> dict:
    from zk_tpu_torch.fields import device as dev

    f = _field(tfields, name)
    cpu_mle = SimpleNamespace(
        new=lambda f, n, v: MLE.new(f, n, v, device="cpu"),
        from_coeff=lambda p: MLE.from_coeff(p, device="cpu"),
    )
    return _tensor_results(
        cpu_mle, ProductPoly, SumOfProducts, f, tcm.CoeffMultilinearPolynomial,
        lambda t: dev.decode_ints(f, t), lambda t: t.tolist(),
    )


@pytest.fixture(scope="module")
def jax_tensor_results(tmp_path_factory):
    """field name -> zk_tpu's results, each field computed once per session."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = once_per_session(
                tmp_path_factory, f"jax_host_surface_tensor_results_{name}", lambda: _jax_tensor_results(name)
            )
        return cache[name]

    return get


@pytest.mark.parametrize("method", ["from_coeff", "mle_eq", "product_partial_evaluate", "product_prod_reduce",
                                    "product_stacked", "product_eq", "sum_of_products"])
@pytest.mark.parametrize("field", TENSOR_FIELDS)
def test_tensor_methods_match_zk_tpu(jax_tensor_results, field, method):
    assert json.loads(json.dumps(_port_tensor_results(field)[method])) == jax_tensor_results(field)[method]


def test_mle_eq_compares_values_not_identity():
    a = MLE.new(tfields.GOLDILOCKS, 2, [1, 2, 3, 4], device="cpu")
    b = MLE.new(tfields.GOLDILOCKS, 2, [1, 2, 3, 4], device="cpu")
    assert a is not b and a == b
    assert a != MLE.new(tfields.GOLDILOCKS, 2, [1, 2, 3, 5], device="cpu")
    assert a != MLE.new(tfields.F17, 2, [1, 2, 3, 4], device="cpu")
