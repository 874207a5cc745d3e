"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

Every ``.cu`` file under ``csrc/`` is compiled for ``sm_90a`` by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with ctypes.  ptxas's
report of each kernel's registers and spills (``-Xptxas -v``) is kept
beside the library as ``<library>.ptxas.txt``.  The library is built at
first use (never at import, so the CPU test suite imports this package
without a CUDA toolchain) into
``zk_tpu_torch/_build/``, keyed by a hash of the sources and flags, so an
edited source always rebuilds.  There is no fallback: a missing ``nvcc``
or a failed build raises with the compiler's stderr.

Each kernel wrapper adds one to its entry in the launch counter exactly
where it launches its kernel; ``reset_launches``/``launches`` let a run
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

KERNELS = (
    "fold_multi", "round_sums", "fold_halfsums", "keccak_f1600", "fold", "round_sums_terms",
    "ntt_ladder", "mont_mul", "lerp", "transcript_round",
)

_LOCK = threading.Lock()
_LIB = None
_LAUNCHES = {name: 0 for name in KERNELS}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def reset_launches() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launches() -> dict[str, int]:
    return dict(_LAUNCHES)


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME/bin (default /usr/local/cuda), else from PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    return shutil.which("nvcc")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into _build/libzk_kernels_<hash>.so (cached): one
    nvcc process per source, run in parallel, then one link: a ``zk.build``
    span."""
    from zk_tpu_torch.utils.stat import span

    digest = _digest()
    out = BUILD_DIR / f"libzk_kernels_{digest}.so"
    if out.exists():
        return out
    with span("zk.build"):
        _compile(digest, out)
    return out


def _compile(digest: str, out: Path) -> None:
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of zk_tpu_torch are built from csrc/ with nvcc for sm_90a"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failed = [], None
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        reports.append(err)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n{err}"
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed is not None:
            raise KernelBuildError(failed)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed (rc={proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text("".join(reports))
        os.replace(tmp, out)
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = ctypes.CDLL(str(build()))
        P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        so.zk_fold_multi.argtypes = [I, I, P, I64, P, I64, I64, P, P, P]
        so.zk_fold_halfsums.argtypes = [I, P, I64, P, I64, I64, I64, I, P, P, P, P]
        so.zk_round_sums.argtypes = [I, I, I, P, I64, I64, I64, I64, I, P, P, P]
        so.zk_keccak_f1600.argtypes = [P, P, P, P, I, P]
        so.zk_fold.argtypes = [I, I, P, I64, I64, P, I64, I64, I64, P, P, P]
        so.zk_round_sums_terms.argtypes = [I, I, I, I, P, I64, I64, I64, I64, I, P, P, P]
        so.zk_ntt_ladder.argtypes = [I, P, P, I, I64, I64, I, P, P, P, P, P]
        so.zk_mont_mul.argtypes = [I, P, P, P, I64, P, P]
        so.zk_lerp.argtypes = [I, P, P, P, P, I64, P, P]
        so.zk_transcript_round.argtypes = [I, P, I, I, P, P, P, I, P, P, P, P, P, P, P, P]
        for name in KERNELS:
            getattr(so, f"zk_{name}").restype = ctypes.c_int
        _LIB = so
        return so


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
