"""The host Keccak-256 in C (csrc/keccak_host.c), loaded with ctypes.

Built at first use with the system C compiler (``$CC``, default ``cc``)
into ``zk_tpu_torch/_build/``, keyed by a hash of the source, apart from
the nvcc library of the CUDA kernels: a host transcript works where there
is no card.  ``load()`` returns None where there is no C compiler, and the
transcript then runs the pure-Python sponge (``keccak.py``, the same
bytes); a compiler that refuses the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from zk_tpu_torch._cuda import BUILD_DIR, CSRC
from zk_tpu_torch.utils.stat import span

_SRC = CSRC / "keccak_host.c"
_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build(cc: str):
    digest = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libzk_keccak_host_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with span("zk.build"):
        proc = subprocess.run([cc, *_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed on {_SRC.name} (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL | None:
    """The loaded C hasher, built on first call; None without a compiler."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        cc = shutil.which(os.environ.get("CC", "cc"))
        if cc is None:
            return None
        lib = ctypes.CDLL(str(_build(cc)))
        P, S = ctypes.c_void_p, ctypes.c_size_t
        lib.zk_keccak_new.argtypes = []
        lib.zk_keccak_new.restype = P
        lib.zk_keccak_free.argtypes = [P]
        lib.zk_keccak_update.argtypes = [P, ctypes.c_char_p, S]
        lib.zk_keccak_finalize_reset.argtypes = [P, ctypes.c_char_p]
        lib.zk_keccak_export.argtypes = [P, ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(S)]
        lib.zk_keccak_import.argtypes = [P, ctypes.c_char_p, ctypes.c_char_p, S]
        for name in ("free", "update", "finalize_reset", "export", "import"):
            getattr(lib, f"zk_keccak_{name}").restype = None
        _LIB = lib
        return lib


class NativeKeccak256:
    """The C implementation of ``keccak.Keccak256``'s interface."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._ctx = lib.zk_keccak_new()
        if not self._ctx:
            raise MemoryError("keccak ctx allocation failed")

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.zk_keccak_free(self._ctx)
            self._ctx = None

    def update(self, data: bytes) -> "NativeKeccak256":
        self._lib.zk_keccak_update(self._ctx, data, len(data))
        return self

    def finalize_reset(self) -> bytes:
        out = ctypes.create_string_buffer(32)
        self._lib.zk_keccak_finalize_reset(self._ctx, out)
        return out.raw

    def export_state(self) -> tuple[list[int], bytes]:
        lanes = ctypes.create_string_buffer(200)
        buf = ctypes.create_string_buffer(136)
        n = ctypes.c_size_t(0)
        self._lib.zk_keccak_export(self._ctx, lanes, buf, ctypes.byref(n))
        raw = lanes.raw
        return [int.from_bytes(raw[8 * i : 8 * i + 8], "little") for i in range(25)], buf.raw[: n.value]

    def import_state(self, lanes, buf: bytes) -> None:
        raw = b"".join(int(l).to_bytes(8, "little") for l in lanes)
        self._lib.zk_keccak_import(self._ctx, raw, bytes(buf), len(buf))
