"""Device-resident Fiat-Shamir transcript: Keccak-256 on torch tensors.

Counterpart of ``zk_tpu.transcript.device``: the same Keccak-256 (0x01
multi-rate padding, rate 136) and the same ``from_be_bytes_mod_order``
challenge mapping as the host ``zk_tpu.transcript.Transcript``, with the
sponge state kept on the device so the prover's round loop never waits on
the host.  The host state moves in through ``state_to_device`` (from
``Transcript.export_state``) and back through ``state_to_host``.

Representation (the reference's, at every public function): 25 sponge
lanes as two (25,) tensors of 32-bit halves ``lo``/``hi``, a (136,) byte
buffer (zero beyond ``pos``), and ``pos`` as a Python int (append sizes
are shape-determined, so block boundaries are known on the host).  Lane
halves and bytes are int64 tensors holding values < 2^32.

``keccak_f1600_device`` launches the CUDA kernel (csrc/keccak.cu) on a
CUDA tensor and runs ``keccak_f1600_plain`` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.transcript.keccak import _RC, _ROT
from zk_tpu_torch import _cuda
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.utils.stat import to_host

RATE = 136
DIGEST = 32
_M32 = 0xFFFFFFFF

# rho offsets in [y][x] layout, pi as a flat gather (zk_tpu.transcript.device)
_ROT_YX = np.array([[_ROT[x][y] for x in range(5)] for y in range(5)], dtype=np.int64)
_PI_SRC = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y


@functools.lru_cache(maxsize=None)
def _keccak_consts(device: torch.device):
    t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
    m = _ROT_YX % 32
    return {
        "m": t(m),
        "mc": t((32 - m) % 32),
        "swap": t((_ROT_YX // 32) % 2 == 1).bool(),
        "mz": t(m == 0).bool(),
        "pi": t(_PI_SRC),
        "rc_lo": [rc & _M32 for rc in _RC],
        "rc_hi": [rc >> 32 for rc in _RC],
        "byte_w": t([1, 1 << 8, 1 << 16, 1 << 24]),
        "shifts": t([0, 8, 16, 24]),
    }


def keccak_f1600_plain(lo: torch.Tensor, hi: torch.Tensor):
    """Keccak-f[1600] on (..., 25) int64 lane halves, whole-state vector
    ops (port of zk_tpu.transcript.device._keccak_f1600_xla)."""
    c = _keccak_consts(lo.device)
    batch = lo.shape[:-1]
    lo = lo.reshape(batch + (5, 5))  # [y][x]
    hi = hi.reshape(batch + (5, 5))
    for r in range(24):
        # theta: d[x] = c[x-1] ^ rol64(c[x+1], 1)
        clo = lo[..., 0, :] ^ lo[..., 1, :] ^ lo[..., 2, :] ^ lo[..., 3, :] ^ lo[..., 4, :]
        chi = hi[..., 0, :] ^ hi[..., 1, :] ^ hi[..., 2, :] ^ hi[..., 3, :] ^ hi[..., 4, :]
        c1lo, c1hi = torch.roll(clo, -1, -1), torch.roll(chi, -1, -1)
        r1lo = ((c1lo << 1) & _M32) | (c1hi >> 31)
        r1hi = ((c1hi << 1) & _M32) | (c1lo >> 31)
        lo = lo ^ (torch.roll(clo, 1, -1) ^ r1lo).unsqueeze(-2)
        hi = hi ^ (torch.roll(chi, 1, -1) ^ r1hi).unsqueeze(-2)
        # rho: per-lane 64-bit rotation as masked 32-bit shifts
        alo = torch.where(c["swap"], hi, lo)
        ahi = torch.where(c["swap"], lo, hi)
        nlo = torch.where(c["mz"], alo, ((alo << c["m"]) & _M32) | (ahi >> c["mc"]))
        nhi = torch.where(c["mz"], ahi, ((ahi << c["m"]) & _M32) | (alo >> c["mc"]))
        # pi: fixed permutation
        nlo = nlo.reshape(batch + (25,))[..., c["pi"]].reshape(batch + (5, 5))
        nhi = nhi.reshape(batch + (25,))[..., c["pi"]].reshape(batch + (5, 5))
        # chi: a = b ^ (~b[x+1] & b[x+2]) along x
        lo = nlo ^ (~torch.roll(nlo, -1, -1) & _M32 & torch.roll(nlo, -2, -1))
        hi = nhi ^ (~torch.roll(nhi, -1, -1) & _M32 & torch.roll(nhi, -2, -1))
        # iota (lo, hi are fresh tensors here)
        lo[..., 0, 0] ^= c["rc_lo"][r]
        hi[..., 0, 0] ^= c["rc_hi"][r]
    return lo.reshape(batch + (25,)), hi.reshape(batch + (25,))


def keccak_f1600_device(lo: torch.Tensor, hi: torch.Tensor):
    """One permutation of (..., 25) int64 lane halves.  Replaces
    zk_tpu/transcript/device.py::_rounds_kernel_pallas: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if lo.shape != hi.shape or lo.shape[-1:] != (25,):
        raise ValueError(f"lane halves must be (..., 25), got {lo.shape}, {hi.shape}")
    if lo.dtype != torch.int64 or hi.dtype != torch.int64:
        raise TypeError("lane halves must be int64")
    if lo.device != hi.device:
        raise ValueError("lane halves on different devices")
    if lo.device.type == "cpu":
        return keccak_f1600_plain(lo, hi)
    if lo.device.type != "cuda":
        raise ValueError(f"unsupported device {lo.device}")
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("lane halves must be contiguous")
    olo, ohi = torch.empty_like(lo), torch.empty_like(hi)
    n = lo.numel() // 25
    err = _cuda.lib().zk_keccak_f1600(
        lo.data_ptr(), hi.data_ptr(), olo.data_ptr(), ohi.data_ptr(), n,
        ctypes.c_void_p(_cuda.stream_ptr(lo.device)),
    )
    _cuda.check(err, "keccak_f1600")
    _cuda.count_launch("keccak_f1600")
    return olo, ohi


# --------------------------------------------------------------------------
# sponge
# --------------------------------------------------------------------------


def _absorb_block(lo, hi, block):
    """XOR a (RATE,) byte block into the state and permute."""
    c = _keccak_consts(lo.device)
    words = (block.reshape(RATE // 8, 2, 4) * c["byte_w"]).sum(-1)  # (17, 2) LE halves
    lo = torch.cat([lo[: RATE // 8] ^ words[:, 0], lo[RATE // 8 :]])
    hi = torch.cat([hi[: RATE // 8] ^ words[:, 1], hi[RATE // 8 :]])
    return keccak_f1600_device(lo, hi)


def absorb(lo, hi, buf, pos: int, data):
    """Absorb a byte vector of known length; returns (lo, hi, buf, new_pos).
    ``buf`` keeps the invariant that bytes beyond ``pos`` are zero."""
    data = data.long()
    cat = torch.cat([buf[:pos], data]) if pos else data
    total = pos + int(data.shape[0])
    nblocks = total // RATE
    for b in range(nblocks):
        lo, hi = _absorb_block(lo, hi, cat[b * RATE : (b + 1) * RATE])
    rem = total % RATE
    new_buf = torch.zeros(RATE, dtype=torch.int64, device=buf.device)
    if rem:
        new_buf[:rem] = cat[nblocks * RATE :]
    return lo, hi, new_buf, rem


def squeeze(lo, hi, buf, pos: int):
    """32-byte digest of everything absorbed (keccak.py:87-98): pad the
    pending block (0x01 ... 0x80), permute a copy, read 4 lanes LE."""
    block = buf.clone()
    if pos == RATE - 1:
        block[pos] = 0x81
    else:
        block[pos] = 0x01
        block[RATE - 1] = 0x80
    plo, phi = _absorb_block(lo, hi, block)
    shifts = _keccak_consts(lo.device)["shifts"]
    lob = (plo[:4, None] >> shifts) & 0xFF  # (4, 4)
    hib = (phi[:4, None] >> shifts) & 0xFF
    return torch.cat([lob, hib], dim=1).reshape(DIGEST)


def sample_challenge(lo, hi, buf, pos: int):
    """transcript/src/lib.rs:20-25: digest, reset, re-absorb the digest.
    Returns (lo, hi, buf, new_pos=32, digest)."""
    digest = squeeze(lo, hi, buf, pos)
    z = torch.zeros(25, dtype=torch.int64, device=lo.device)
    zb = torch.zeros(RATE, dtype=torch.int64, device=lo.device)
    lo, hi, buf, rem = absorb(z, z, zb, 0, digest)
    return lo, hi, buf, rem, digest


# --------------------------------------------------------------------------
# digest -> field element, canonical serialization
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _challenge_consts(field: Field, device: torch.device) -> torch.Tensor:
    """(L, 32): column j = canonical limbs of 2^(8 (31-j)) * R^2 mod p, so
    mont_mul(byte_j, col_j) is the Montgomery form of byte j's share of
    the big-endian integer."""
    L = field.n_limbs
    out = np.zeros((L, DIGEST), dtype=np.int64)
    for j in range(DIGEST):
        c = (pow(2, 8 * (DIGEST - 1 - j), field.p) * field.R2) % field.p
        out[:, j] = dev._int_to_limbs(c, L)
    return torch.from_numpy(out).to(device)


def challenge_from_digest(field: Field, digest):
    """(32,) digest bytes -> (mont (L, 1), canonical (L, 1)) int32 limbs of
    from_be_bytes_mod_order(digest) (transcript/src/lib.rs:27-30)."""
    if field.p <= (1 << 32):
        raise ValueError("device transcript requires p > 2^32")
    L = field.n_limbs
    b = torch.zeros((L, DIGEST), dtype=torch.int64, device=digest.device)
    b[0] = digest
    prods = dev.mont_mul(field, b, _challenge_consts(field, digest.device))
    mont = dev.sum_mod(field, prods, -1).reshape(L, 1)
    canon = dev.from_mont(field, mont)
    return mont, canon


@functools.lru_cache(maxsize=None)
def _byte_gather(field: Field, device: torch.device):
    """(limb index, shift, keep-mask) per BE byte of one canonical element."""
    nb, L = field.n_bytes, field.n_limbs
    idx = np.zeros(nb, dtype=np.int64)
    shift = np.zeros(nb, dtype=np.int64)
    valid = np.zeros(nb, dtype=np.int64)
    for bpos in range(nb):
        q = nb - 1 - bpos  # byte significance
        if q // 2 < L:
            idx[bpos], shift[bpos], valid[bpos] = q // 2, 8 * (q % 2), 0xFF
    return tuple(torch.from_numpy(a).to(device) for a in (idx, shift, valid))


def serialize_canonical(field: Field, elems):
    """(L, count) canonical limbs -> (count * n_bytes,) int64 byte values,
    each element big-endian (field.py elements_to_bytes)."""
    idx, shift, valid = _byte_gather(field, elems.device)
    mat = (elems.long()[idx, :] >> shift[:, None]) & valid[:, None]  # (nb, count)
    return mat.t().reshape(-1)


# --------------------------------------------------------------------------
# host <-> device state
# --------------------------------------------------------------------------


STATE_WORDS = 25 + 25 + RATE  # lo, hi, buf: a sponge state as one int64 vector


def state_words(lanes, buf: bytes, out: np.ndarray) -> None:
    """Host sponge state (25 lane ints, pending bytes) -> lo, hi, buf in
    the (STATE_WORDS,) int64 array ``out``."""
    out[:25] = [l & _M32 for l in lanes]
    out[25:50] = [l >> 32 for l in lanes]
    out[50:] = 0
    out[50 : 50 + len(buf)] = np.frombuffer(bytes(buf), dtype=np.uint8)


def split_state(words: torch.Tensor):
    """A (STATE_WORDS,) int64 tensor -> its (lo, hi, buf) views."""
    return words[:25], words[25:50], words[50:]


def state_to_device(lanes, buf: bytes, device):
    """Host sponge state (25 lane ints, pending bytes) -> (lo, hi, buf, pos):
    views of one (STATE_WORDS,) tensor, uploaded in one copy."""
    words = np.empty(STATE_WORDS, dtype=np.int64)
    state_words(lanes, buf, words)
    return (*split_state(torch.from_numpy(words).to(device)), len(buf))


def state_to_host(lo, hi, buf, pos: int):
    """Device state -> (25 lane ints, pending bytes) for
    Transcript.import_state: one read-back."""
    flat = to_host(torch.cat([lo, hi, buf]))
    return state_from_host(flat[:25], flat[25:50], flat[50:], pos)


def state_from_host(lo, hi, buf, pos: int):
    """``state_to_host`` of a state already read back (CPU tensors or
    numpy arrays)."""
    lo, hi = np.asarray(lo).astype(np.uint64), np.asarray(hi).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).tolist(), np.asarray(buf)[:pos].astype(np.uint8).tobytes()
