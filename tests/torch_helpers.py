"""Helpers shared by the port's tests (tests/test_torch_*.py).

``once_per_session`` computes a JAX-side result once per test session, not
once per worker.  pytest-xdist (``--dist load``) hands the tests of one
module to several workers, and a module- or session-scoped fixture runs
again in every worker that draws one of its tests.  It follows
pytest-xdist's documented recipe: the first worker to take an exclusive
``fcntl`` lock on a file beside the workers' temporary directories
computes the value and writes it there as JSON; every other worker waits
on the lock and reads the file.  Without workers (``-n 0``) it simply
computes the value.  Values must survive a JSON round trip (ints, str,
lists, dicts with str keys).

``host_ints`` and ``mont_limbs`` convert between (L, N) uint32 Montgomery
limb arrays and canonical Python ints with plain integer arithmetic, so a
test can hold a plain version against the definition of what it computes.
"""

from __future__ import annotations

import fcntl
import json
import os

import numpy as np


def once_per_session(tmp_path_factory, name: str, compute):
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return json.loads(json.dumps(compute()))
    path = tmp_path_factory.getbasetemp().parent / f"{name}.json"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.is_file():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                tmp.write_text(json.dumps(compute()))
                os.replace(tmp, path)
            return json.loads(path.read_text())
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def host_ints(field, limbs) -> list[int]:
    """(L, N) Montgomery limbs (any integer array) -> canonical ints."""
    a = np.asarray(limbs).astype(np.int64)
    r_inv = pow(field.R, -1, field.p)
    return [
        sum(int(a[i, j]) << (16 * i) for i in range(a.shape[0])) * r_inv % field.p
        for j in range(a.shape[1])
    ]


def mont_limbs(field, values) -> np.ndarray:
    """Canonical ints -> (L, N) uint32 Montgomery limbs."""
    out = np.empty((field.n_limbs, len(values)), dtype=np.uint32)
    for j, v in enumerate(values):
        m = v % field.p * field.R % field.p
        for i in range(field.n_limbs):
            out[i, j] = (m >> (16 * i)) & 0xFFFF
    return out


def lerp_int(field, left: int, right: int, r: int) -> int:
    """left - r (left - right) mod p: the fold step's definition."""
    return (left - r * (left - right)) % field.p
