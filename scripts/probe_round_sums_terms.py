"""What holds round_sums_terms back, on one NVIDIA GPU.

Run from the repository root on a card:

    python3 scripts/probe_round_sums_terms.py [--parent DIR]

At GKR's first-round shape, (D, term sizes) = (2, (2, 2)) over a 2^19
BLS12-381 stack, it times csrc/capacity.cu's ``round_sums_terms`` built
several ways from copies of the source, with CUDA events in turns on one
card:

  * ``shipped``: the kernel as it is;
  * ``memory``: the Montgomery products and the modular adds and
    subtractions taken out (XORs in their place), so only the loads, the
    control flow and the limb accumulation are left;
  * ``compute``: the global loads replaced by values made from the pair
    and factor index, so only the arithmetic and the accumulation are
    left (the partials are still written);
  * ``2 blocks``, ``4 blocks``: the shipped design (one point a block)
    with its launch bounds asking for that many resident blocks per SM
    instead of three;
  * ``unrolled`` (and with ``2 blocks``): the factor loop unrolled, so the
    compiler may issue a later factor's loads before an earlier factor's
    product (one inlined product a factor past each term's first).

With ``--parent`` it also builds that checkout's kernel as shipped and
times it in the same turns.  Every variant that keeps the arithmetic and
the loads is checked equal to the plain version.
Beside each time it prints the kernel's registers and spills (ptxas),
its SASS instructions (cuobjdump), its resident blocks per SM (the
occupancy API), the Montgomery products a millisecond and the
bytes a second the shape's work implies.

Variant sources are built under zk_tpu_torch/_build/probe_rst/
(gitignored) by scripts/_probe.py, one nvcc process each, all started
together.  The card's name and power limit come first, as nvidia-smi
reports them.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from _probe import build, card_line, patch  # noqa: E402
from chip_smoke import bound, cuda_ms, elem_bytes, kernel_resources, rand_limbs, sass_counts  # noqa: E402
from zk_tpu_torch import _cuda  # noqa: E402
from zk_tpu_torch.fields import BLS12_381_FR as FR  # noqa: E402
from zk_tpu_torch.sumcheck import capacity as C  # noqa: E402

PROBE_DIR = _cuda.BUILD_DIR / "probe_rst"
LOG = 19
TERMS = (2, 2)
INSTANCE = "round_sums_terms_kernel<8,2,2,2>"
KERNEL_START = "round_sums_terms_kernel(const uint32_t* stack"
UNROLL_1 = "#pragma unroll 1\n"
FACTOR_LOOP = "    for (int j = 0; j < K; ++j) {"
XOR = "for (int w = 0; w < NW; ++w) {dst}[w] = {a}[w] ^ {b}[w];"
FAKE = "for (int w = 0; w < NW; ++w) {dst}[w] = (uint32_t)(({e}) * 0x9E3779B9u + 977u * j + w) & 0x0FFFFFFFu;"

THREADS = 256  # a block, in both designs
# the shape's work: per pair and term, (k - 1)(D + 1) products
PRODUCTS = sum((k - 1) * 3 for k in TERMS)
MEMORY = [  # the products and modular adds and subtractions made XORs
    ("mont_mul<NW>(prod, prod, ev, fp);", XOR.format(dst="prod", a="prod", b="ev")),
    ("sub_mod<NW>(left, ev, left, fp);", XOR.format(dst="left", a="ev", b="left")),
    ("add_mod<NW>(ev, ev, left, fp);", XOR.format(dst="ev", a="ev", b="left")),
]
COMPUTE = [  # the loads made values of the pair and factor index
    ("load_elem<NW>(left, f, row_stride, e);", FAKE.format(dst="left", e="e")),
    ("load_elem<NW>(ev, f, row_stride, e + half);", FAKE.format(dst="ev", e="e + half")),
]
BOUNDS = ("__launch_bounds__(THREADS, RST_MIN_BLOCKS)", "__launch_bounds__(THREADS, {})")
UNROLL = (UNROLL_1 + FACTOR_LOOP, "#pragma unroll\n" + FACTOR_LOOP)
VARIANTS = {
    "shipped": [],
    "memory": MEMORY,
    "compute": COMPUTE,
    "4 blocks": [(BOUNDS[0], BOUNDS[1].format(4))],
    "2 blocks": [(BOUNDS[0], BOUNDS[1].format(2))],
    "unrolled": [UNROLL],
    "unrolled 2 blocks": [UNROLL, (BOUNDS[0], BOUNDS[1].format(2))],
}

REPORT = r"""
extern "C" int probe_report(int threads, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, round_sums_terms_kernel<8, 2, 2, 2>, threads, 0);
}
"""


def _patch_kernel(src: str, patches) -> str:
    """Apply each (old, new) once, inside round_sums_terms_kernel (from its
    template line to its closing brace)."""
    start = src.rindex("template", 0, src.index(KERNEL_START))
    end = src.index("\n}\n", start)
    body = src[start:end]
    for old, new in patches:
        body = patch(body, old, new, "round_sums_terms_kernel in capacity.cu")
    return src[:start] + body + src[end:]


def build_all(parent: Path | None):
    """{name: (lib, (registers, spill stores, spill loads), SASS instructions)}
    of this tree's variants and the parent's shipped kernel."""
    src = (_cuda.CSRC / "capacity.cu").read_text()
    sources = {f"this {name}": (_patch_kernel(src, patches) + REPORT, _cuda.CSRC)
               for name, patches in VARIANTS.items()}
    if parent is not None:
        sources["parent shipped"] = ((parent / "capacity.cu").read_text() + REPORT, parent)
    out = {}
    for name, (lib, so, ptxas) in build(sources, PROBE_DIR).items():
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.zk_round_sums_terms.argtypes = [I, I, I, I, P, I64, I64, I64, I64, I, P, P, P]
        lib.probe_report.argtypes = [I, P]
        out[name] = (lib, kernel_resources(ptxas).get(INSTANCE), sass_counts(so).get(INSTANCE))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout whose round_sums_terms to probe in the same turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe runs only on a GPU")
    print(card_line(), flush=True)
    _cuda.lib()
    libs = build_all(Path(args.parent).resolve() / "zk_tpu_torch" / "csrc" if args.parent else None)
    size = 1 << LOG
    gen = torch.Generator(device="cuda").manual_seed(43)
    stack = rand_limbs(FR, (sum(TERMS), FR.n_limbs, size), gen)
    want = C.round_sums_terms_plain(FR, 2, TERMS, stack, size)
    nbytes = sum(TERMS) * size * elem_bytes(FR)
    order = list(libs) + list(reversed(libs))
    rows = {name: [] for name in libs}
    saved = _cuda._LIB
    try:
        for name in order:
            lib = libs[name][0]
            _cuda._LIB = lib
            run = lambda: C.round_sums_terms(FR, 2, TERMS, stack, size)  # noqa: E731
            if not name.endswith(("memory", "compute")) and not torch.equal(run(), want):
                raise AssertionError(f"{name}: round_sums_terms != plain version")
            rows[name].append(cuda_ms(run, 20))
    finally:
        _cuda._LIB = saved
    print(f"round_sums_terms (2, {TERMS}) 2^{LOG} BLS12-381 (CUDA-event means of 20 launches, two turns):")
    print("variant | ms (turns) | products/ms | GB/s | bound ms | regs | spills st/ld | SASS | blocks/SM x threads")
    for name, times in rows.items():
        lib, res, sass = libs[name]
        per_sm = ctypes.c_int()
        err = lib.probe_report(THREADS, ctypes.byref(per_sm))
        if err:
            raise RuntimeError(f"probe_report: CUDA error {err}")
        ms = min(times)
        work = PRODUCTS * size // 2
        b = bound(nbytes, work)
        regs, st, ld = res or ("?", "?", "?")
        print(f"{name} | {' / '.join(f'{t:.4f}' for t in times)} | {work / ms / 1e6:.2f}M | {nbytes / ms / 1e6:.1f} | "
              f"{b[0]:.4f} ({b[1]}) | {regs} | {st}/{ld} | {sass} | {per_sm.value} x {THREADS}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
