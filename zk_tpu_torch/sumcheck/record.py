"""The round record of a device-transcript prove: one workspace planned
before round 1, every round queued into it, one read and a one-pass decode.

Counterpart of the device round loop that zk_tpu jits
(zk_tpu/sumcheck/capacity.py ``_transcript_round_cap`` and its fused
rounds).  ``RoundRecord`` is planned once a prove from what the call
observes (field, degree, the terms' factor counts, the device, and each
phase's table size, rounds and fold past its last round) and allocates
one byte buffer on the table's device, with typed views:

  * the first fold's half-size table (degree 1, one factor: that fold
    writes a fresh table, so the statement's stays as it is);
  * two partials slots (D+1, L, G) int64, the round sums' accumulators;
  * two sponge slots (lo, hi, buf) int64 (``transcript.device.STATE_WORDS``);
  * the record, read back in one piece: the final sponge, the canonical
    round sums (rounds, L, D+1), the canonical and the Montgomery
    challenges (rounds, L, 1), and the canonical host-tail table where
    one follows.

Row ``r`` of the record is one round.  Its Fiat-Shamir step reads
partials slot r % 2 and sponge slot r % 2 (row 0: the uploaded sponge, or
the one a GKR phase hands in), writes row r and the other sponge slot (the
last row: the record's sponge); its table kernel folds at row r's
Montgomery challenge and writes the next round's partials into the other
partials slot.  Slots alternate, so no kernel reads what it writes.

Shapes, dtypes and the device are checked once a phase, before its
first round; data pointers and the stream are taken there too.  On a card
a round is then its kernels launched through ctypes with those pointers:
no allocation, check or torch op.  On the CPU the plain versions run and
their results are copied into the same views, so the CPU tests run the
same bookkeeping.  Nothing outlives the prove.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from zk_tpu_torch import _cuda
from zk_tpu_torch.fields import device as dev
from zk_tpu_torch.fields.field import Field
from zk_tpu_torch.fields.kernels import check_cuda, cuda_stream
from zk_tpu_torch.sumcheck import capacity as C
from zk_tpu_torch.sumcheck import kernels as K
from zk_tpu_torch.transcript import device as tdev
from zk_tpu_torch.utils.stat import span, to_host

_ALIGN = 256  # bytes between the workspace's views
_SPONGE = tdev.STATE_WORDS


def _up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def decode_rows(field: Field, sums: np.ndarray, chs: np.ndarray) -> tuple[list[list[int]], list[int]]:
    """Canonical limbs of the record, (rounds, L, D+1) round sums and
    (rounds, L, 1) challenges, -> (round polynomials, challenges) as ints:
    one (rounds, D+2, L) uint16 pass, one ``int.from_bytes`` an element."""
    rounds, _, P = sums.shape
    ints = dev.limb_ints(field, np.concatenate([sums, chs], axis=2).transpose(0, 2, 1))
    return [ints[r * (P + 1) : r * (P + 1) + P] for r in range(rounds)], ints[P :: P + 1]


class RoundRecord:
    """The workspace of one device-transcript prove (module docstring).

    ``phases``: one (size, rounds, fold_last) a ``queue`` call, in order:
    the entries of the table the phase starts from, its rounds, and
    whether it folds past its last round (a host tail or a later phase
    continues from the table).  The first phase folds the statement's
    stack (a degree-1 single factor's first fold writes the record's fresh
    table; every other shape's stack is a fresh copy, folded in place);
    a later phase folds the fresh table its caller hands in.  Where the
    last phase folds past its last round, the host tail's table is read
    back with the record."""

    def __init__(self, field: Field, degree: int, ks, device, *phases):
        ks = tuple(ks)
        if field.p <= (1 << 32):
            raise ValueError("device transcript requires p > 2^32")
        if not 1 <= degree <= C.MAX_DEGREE or not ks or min(ks) < 1:
            raise ValueError(f"no round for degree {degree} and terms {ks}")
        if not phases:
            raise ValueError("round record: no phase")
        L, P, rows = field.n_limbs, degree + 1, sum(ks)
        self.field, self.degree, self.ks = field, degree, ks
        self.rounds = sum(rounds for _, rounds, _ in phases)
        self.deg1 = (degree, ks) == (1, (1,))
        self.G = max(C.partition(max(size, 2) // 2, len(ks))[0] for size, _, _ in phases)  # partials a slot holds
        size, rounds, fold_last = phases[0]
        fresh = size // 2 if self.deg1 and (rounds > 1 or (rounds == 1 and fold_last)) else 0
        size, rounds, fold_last = phases[-1]
        self.tail_n = size >> rounds if fold_last else 0
        parts = {
            "fold": 4 * L * fresh, "p0": 8 * P * L * self.G, "p1": 8 * P * L * self.G,
            "s0": 8 * _SPONGE, "s1": 8 * _SPONGE,
            "final": 8 * _SPONGE, "sums": 4 * self.rounds * L * P, "chs": 4 * self.rounds * L,
            "mont": 4 * self.rounds * L, "tail": 4 * L * rows * self.tail_n,
        }
        self.at, off = {}, 0  # byte offsets of the views in the workspace
        for name, n in parts.items():
            self.at[name] = off
            off += _up(n)
        self.ws = torch.empty(off, dtype=torch.uint8, device=device)
        self.fold = self._view("fold", torch.int32, (1, L, fresh)) if fresh else None
        self.record = self.ws[self.at["final"] : self.at["tail"] + parts["tail"]]
        self.phases, self.phase, self.row = phases, 0, 0
        self.pos = None
        self._start = None  # row 0's sponge: the slot it was uploaded to, or the (lo, hi, buf) handed in

    # views, made where a caller needs a tensor (a card's rounds take pointers)

    def _view(self, name: str, dtype, shape):
        at = self.at[name]
        return self.ws[at : at + math.prod(shape) * dtype.itemsize].view(dtype).view(shape)

    @functools.cached_property
    def sums(self):
        """Canonical round sums, (rounds, L, D+1) int32."""
        return self._view("sums", torch.int32, (self.rounds, self.field.n_limbs, self.degree + 1))

    @functools.cached_property
    def chs(self):
        """Canonical challenges, (rounds, L, 1) int32."""
        return self._view("chs", torch.int32, (self.rounds, self.field.n_limbs, 1))

    @functools.cached_property
    def chs_mont(self):
        """Montgomery challenges, (rounds, L, 1) int32."""
        return self._view("mont", torch.int32, (self.rounds, self.field.n_limbs, 1))

    @functools.cached_property
    def final(self):
        """The final sponge, a (STATE_WORDS,) int64 vector."""
        return self._view("final", torch.int64, (_SPONGE,))

    @functools.cached_property
    def tail(self):
        """The host tail's canonical table, (L, rows * n) int32."""
        if not self.tail_n:
            return None
        return self._view("tail", torch.int32, (self.field.n_limbs, sum(self.ks) * self.tail_n))

    # -- the sponge in and out ------------------------------------------

    def upload(self, lanes, pending: bytes) -> None:
        """The host transcript's state into the first sponge slot: one
        non-blocking copy from one pinned host buffer (on a card the host
        goes on without waiting for the stream)."""
        host = torch.empty(_SPONGE, dtype=torch.int64, pin_memory=self.ws.is_cuda)
        tdev.state_words(lanes, pending, host.numpy())
        self.ws[self.at["s0"] : self.at["s0"] + 8 * _SPONGE].copy_(host.view(torch.uint8), non_blocking=True)
        self._start, self.pos = "s0", len(pending)

    def attach(self, lo, hi, buf, pos: int) -> None:
        """A sponge already on the device (a GKR phase continues the
        chain's) as row 0's; the record's final sponge continues it."""
        if not self.rounds:
            raise ValueError("round record: a handed-in sponge needs at least one round")
        if self.ws.is_cuda:
            check_cuda(self.field, "round record", self.ws, lo, hi, buf)
        if (lo.dtype, hi.dtype, buf.dtype) != (torch.int64,) * 3 or (lo.numel(), hi.numel(), buf.numel()) != (
                25, 25, tdev.RATE):
            raise ValueError("round record: the sponge must be int64 (25,), (25,), (136,) tensors")
        self._start, self.pos = (lo, hi, buf), pos

    def sponge(self):
        """The final sponge as (lo, hi, buf) views of the record (pos 32)."""
        return tdev.split_state(self.final)

    def _sponge_in(self, row: int):
        """Row ``row``'s sponge: the name of its slot, or the tensors handed in."""
        return self._start if row == 0 else f"s{row % 2}"

    def _sponge_out(self, row: int) -> str:
        return "final" if row == self.rounds - 1 else f"s{(row + 1) % 2}"

    def _state(self, sponge):
        return tdev.split_state(self._view(sponge, torch.int64, (_SPONGE,))) if isinstance(sponge, str) else sponge

    def _G(self, size: int) -> int:
        """Partials of the sums kernel over a table of ``size`` entries (of
        fold_halfsums folding one: the same chunking of size / 2)."""
        return C.partition(size // 2, len(self.ks))[0]

    def _partials(self, slot: int, G: int):
        return self._view(f"p{slot}", torch.int64, (self.degree + 1, self.field.n_limbs, G))

    # -- queueing -------------------------------------------------------

    def queue(self, stack, reduce=None):
        """Queue the next phase's rounds (prover.rs:44-68) over its
        (sum(ks), L, n) stack from the record's next row: the first round
        sums, then per round, in one ``zk.prove.round`` span, the
        Fiat-Shamir step and the fold at its challenge with the next
        round's sums.  Nothing waits on the device.  ``reduce`` (the
        sharded prover's): called on every round's partials before the
        Fiat-Shamir step, it returns the whole table's (P, L, G') partials.
        Returns the last table's live prefix."""
        size, rounds, fold_last = self.phases[self.phase]
        owned = self.phase > 0 or not self.deg1
        self.phase += 1
        if not rounds:
            return stack[:, :, :size]
        self._check(stack, size, rounds, fold_last, owned)
        steps = _CudaSteps(self, stack) if stack.device.type == "cuda" else _PlainSteps(self)
        steps.sums(stack, size, self.row % 2)
        G, first = self._G(size), self.row
        for row in range(first, first + rounds):
            with span("zk.prove.round"):
                last = row == first + rounds - 1
                steps.transcript(row, G, None if reduce is None else reduce(self._partials(row % 2, G)))
                if not last or fold_last:
                    out = stack if owned else self.fold
                    if not self.deg1:
                        steps.fold(stack, out, size, row)
                        if not last:
                            steps.sums(out, size // 2, (row + 1) % 2)
                            G = self._G(size // 2)
                    elif not last:
                        steps.fold_halfsums(stack, out, size, row, (row + 1) % 2)
                        G = self._G(size)  # the folded table's half sums, over its size / 2 entries
                    else:
                        steps.fold_multi(stack, out, size, row)
                    stack, owned, size = out, True, size // 2
        self.row += rounds
        return stack[:, :, :size]

    def _check(self, stack, size: int, rounds: int, fold_last: bool, owned: bool) -> None:
        field, L = self.field, self.field.n_limbs
        if stack.shape[-1] != size:
            raise ValueError(f"round record: a {stack.shape[-1]}-entry table where the plan has {size}")
        C._check_stack(field, stack, size, "round record")
        if stack.shape[0] != sum(self.ks):
            raise ValueError(f"round record: {stack.shape[0]} factor rows for the terms {self.ks}")
        if self._start is None:
            raise ValueError("round record: no sponge (upload or attach one first)")
        if size >> (rounds - 1) < 2:
            raise ValueError(f"round record: {rounds} rounds of a {size}-entry table do not fit")
        if stack.device.type != "cuda":
            return
        check_cuda(field, "round record", stack, self.ws, *(() if isinstance(self._start, str) else self._start))
        if field.n_bytes != 2 * L:
            raise ValueError(f"round record: no transcript_round kernel for {field.name}")
        if not self.deg1:
            shapes = C.ROUND_SUMS_SHAPES if len(self.ks) == 1 else C.ROUND_SUMS_TERMS_SHAPES
            shape = (self.degree, self.ks[0] if len(self.ks) == 1 else self.ks)
            if shape not in shapes:
                raise ValueError(f"round record: no sums kernel for (degree, terms) = {shape}")
            if stack.shape[0] > C.FOLD_MAX_FACTORS:
                raise ValueError(f"round record: no fold kernel for {stack.shape[0]} factors")

    # -- the read -------------------------------------------------------

    def read(self, transcript, round_polys: list, challenges: list, n_vars: int, table) -> None:
        """The prove's one host sync: the record in one read (where a host
        tail follows, the last phase's ``table`` un-scaled into it first),
        then, in one decode span, the rows as ints, the sponge into
        ``transcript``, and the rounds left of n_vars on host ints."""
        field, L = self.field, self.field.n_limbs
        if self.phase != len(self.phases):
            raise ValueError(f"round record: {len(self.phases) - self.phase} planned phases not queued")
        if self.tail_n:
            rows, _, n = table.shape
            if rows * n != self.tail.shape[1]:
                raise ValueError(f"round record: no room planned for a host tail of {rows} x {n} entries")
            dev._canonical(field, table.permute(1, 0, 2).reshape(L, rows * n), True, out=self.tail)
        raw = to_host(self.record).numpy()
        with span("zk.prove.decode"):
            R, P = self.rounds, self.degree + 1
            if R:
                at, n = self.at["sums"] - self.at["final"], 4 * R * L * P
                sums = raw[at : at + n].view("<i4").reshape(R, L, P)
                at, n = self.at["chs"] - self.at["final"], 4 * R * L
                chs = raw[at : at + n].view("<i4").reshape(R, L, 1)
                polys, chals = decode_rows(field, sums, chs)
                round_polys += polys
                challenges += chals
                words = raw[: 8 * _SPONGE].view("<i8")
                transcript.import_state(*tdev.state_from_host(words[:25], words[25:50], words[50:], 32))
            if self.tail_n:
                limbs = raw[len(raw) - 4 * self.tail.numel() :].view("<i4").reshape(L, -1)
                host = K.HostTables.of_rows(field, self.ks, dev.limb_ints(field, limbs.T), table.shape[-1])
                host.rounds(self.degree, n_vars - len(challenges), transcript, round_polys, challenges)


class _CudaSteps:
    """A round's kernels launched through ctypes with pointers into the
    record, taken once: nothing here makes a tensor or a view."""

    def __init__(self, rec: RoundRecord, stack):
        self.rec, self.lib, self.stream = rec, _cuda.lib(), cuda_stream(stack)
        L, P = rec.field.n_limbs, rec.degree + 1
        self.row_sums, self.row_ch = 4 * L * P, 4 * L
        self.at = {name: rec.ws.data_ptr() + at for name, at in rec.at.items()}

    @staticmethod
    def _launch(fn, args, name: str) -> None:
        err = fn(*args)
        if err:
            _cuda.check(err, name)
        _cuda.count_launch(name)

    def _state(self, sponge):
        """(lo, hi, buf) pointers of a sponge slot's name, or of the tensors handed in."""
        if not isinstance(sponge, str):
            return [t.data_ptr() for t in sponge]
        at = self.at[sponge]
        return at, at + 8 * 25, at + 8 * 50

    def _mont(self, row: int) -> int:
        return self.at["mont"] + row * self.row_ch

    def sums(self, stack, size: int, slot: int):
        rec, partials = self.rec, self.at[f"p{slot}"]
        if len(rec.ks) == 1:
            args = C.round_sums_args(rec.field, rec.degree, stack.shape[0], stack.data_ptr(), stack.shape[2], size,
                                     partials, self.stream)
            self._launch(self.lib.zk_round_sums, args, "round_sums")
        else:
            args = C.round_sums_terms_args(rec.field, rec.degree, rec.ks, stack.data_ptr(), stack.shape[2], size,
                                           partials, self.stream)
            self._launch(self.lib.zk_round_sums_terms, args, "round_sums_terms")

    def fold_halfsums(self, stack, out, size: int, row: int, slot: int):
        args = C.fold_halfsums_args(self.rec.field, stack.data_ptr(), stack.shape[2], out.data_ptr(), out.shape[2],
                                    size, self._mont(row), self.at[f"p{slot}"], self.stream)
        self._launch(self.lib.zk_fold_halfsums, args, "fold_halfsums")

    def fold(self, stack, out, size: int, row: int):
        args = C.fold_args(self.rec.field, stack.shape[0], stack.data_ptr(), stack.shape[2], out.data_ptr(),
                           out.shape[2], size, self._mont(row), self.stream)
        self._launch(self.lib.zk_fold, args, "fold")

    def fold_multi(self, stack, out, size: int, row: int):
        args = C.fold_multi_args(self.rec.field, 1, stack.data_ptr(), stack.shape[2], out.data_ptr(),
                                 out.shape[2], size // 2, self._mont(row), self.stream)
        self._launch(self.lib.zk_fold_multi, args, "fold_multi")

    def transcript(self, row: int, G: int, partials=None):
        """Row ``row``'s Fiat-Shamir step on its partials slot, or on the
        reduced ``partials`` tensor."""
        rec = self.rec
        src = self.at[f"p{row % 2}"] if partials is None else partials.data_ptr()
        G = G if partials is None else partials.shape[2]
        out = (*self._state(rec._sponge_out(row)), self.at["sums"] + row * self.row_sums,
               self.at["chs"] + row * self.row_ch, self._mont(row))
        args = K.transcript_round_args(rec.field, src, rec.degree + 1, G, self._state(rec._sponge_in(row)),
                                       rec.pos if row == 0 else 32, out, self.stream)
        self._launch(self.lib.zk_transcript_round, args, "transcript_round")


class _PlainSteps:
    """The same steps as the kernels' plain versions (CPU tensors), their
    results copied into the record's views."""

    def __init__(self, rec: RoundRecord):
        self.rec = rec

    def sums(self, stack, size: int, slot: int):
        rec = self.rec
        got = C.round_sums_terms_plain(rec.field, rec.degree, rec.ks, stack, size)
        rec._partials(slot, rec._G(size)).copy_(got)

    def fold_halfsums(self, stack, out, size: int, row: int, slot: int):
        rec = self.rec
        _, got = C.fold_halfsums_plain(rec.field, stack, size, rec.chs_mont[row], out)
        rec._partials(slot, rec._G(size)).copy_(got)

    def fold(self, stack, out, size: int, row: int):
        C.fold_plain(self.rec.field, stack, size, self.rec.chs_mont[row], out)

    def fold_multi(self, stack, out, size: int, row: int):
        C.fold_multi_plain(self.rec.field, stack, size, self.rec.chs_mont[row], out)

    def transcript(self, row: int, G: int, partials=None):
        rec = self.rec
        partials = rec._partials(row % 2, G) if partials is None else partials
        got = K.transcript_round_plain(rec.field, rec.pos if row == 0 else 32, *rec._state(rec._sponge_in(row)),
                                       partials)
        out = (*rec._state(rec._sponge_out(row)), rec.sums[row], rec.chs[row], rec.chs_mont[row])
        for dst, src in zip(out, got):
            dst.copy_(src)
