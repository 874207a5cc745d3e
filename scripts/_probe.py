"""What the kernel probes (scripts/probe_*.py) share: the card line, patching
a kernel's source, and building its variants.

A probe builds copies of a csrc/ file with parts of a kernel taken out,
one shared library a variant under zk_tpu_torch/_build/ (gitignored), and
times them in turns on one card.  A patch that no longer matches its
source fails loudly, so a probe never times a variant it did not build.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

from zk_tpu_torch import _cuda


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def patch(src: str, old: str, new: str, where: str) -> str:
    """Replace ``old``, which must occur exactly once in ``src``, by ``new``."""
    if src.count(old) != 1:
        raise RuntimeError(f"{where} changed: the probe's patch point {old.strip()[:60]!r} is not unique")
    return src.replace(old, new)


def build(sources: dict[str, tuple[str, Path]], out_dir: Path) -> dict[str, tuple[ctypes.CDLL, Path, str]]:
    """Build {name: (CUDA source text, include dir)} with one nvcc process a
    source, all started together; returns {name: (library, .so path,
    ptxas report)}."""
    nvcc = _cuda.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (text, include) in sources.items():
        stem = name.replace(" ", "_")
        cu, so = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
        cu.write_text(text)
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-I", str(include), "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        out[name] = (ctypes.CDLL(str(so)), so, err)
    return out
