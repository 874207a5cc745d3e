"""Ranks for a cell on several cards: one process a card, driven by rank 0.

The process that run.py starts is rank 0.  ``start`` starts ranks 1..R-1
as fresh Python processes (this file run as a script; they load the job
kind's file and nothing of JAX), each on ``cuda:<rank>`` (on the CPU, for
the tests, each a gloo rank), and joins all R in one process group
(NCCL, gloo on the CPU) through a ``file://`` rendezvous in a temporary
directory, with a finite timeout.  Rank 0 forwards each command to the
other ranks over their pipes as a pickled (name, args): every rank,
rank 0 too, runs ``rank_<name>(ctx, *args)`` of the kind, where ``ctx``
is the rank's own namespace (rank, ranks, device and whatever the kind
keeps there), and answers with its result.  Two commands are the mesh's
own, whatever the kind: ``peak``, every rank's peak of device memory
(its cached blocks then freed), and ``forbidden``, the modules of JAX or
the JAX package that each rank has loaded; the harness asks the active
mesh for both (``active``).

A run never hangs on a rank.  A watchdog thread in rank 0 ends the whole
run (every rank killed and waited for, a line on standard error, exit
code 3, so no result line) when another rank exits or raises, or when a
command has not been answered within its deadline.  A rank ends when
rank 0 ends, however it ends: the kernel's parent-death signal, and the
end of its command pipe.  ``stop`` (and, failing that, the exit of
rank 0) stops every rank and waits for each.
"""

from __future__ import annotations

import atexit
import os
import pickle
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent  # the checkout
SETUP_S = 900.0  # a set-up command's deadline: the first run of a checkout builds the kernels in it
TIMEOUT_S = 120.0  # any other command's deadline on every rank, and the process group's timeout
_ACTIVE: Mesh | None = None


def _group(rank: int, ranks: int, init: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    if device.startswith("cuda"):
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device.startswith("cuda") else "gloo", init_method=init, rank=rank,
                            world_size=ranks, timeout=timedelta(seconds=TIMEOUT_S))


def _peak(ctx) -> int | None:
    import torch

    if not ctx.device.startswith("cuda"):
        return None
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()  # the window's blocks go back before the reference runs
    return peak


def _forbidden(ctx) -> list[str]:
    from benchmark import harness

    return [f"rank {ctx.rank}: {m}" for m in harness.forbidden_modules()]


_OWN = {"peak": _peak, "forbidden": _forbidden}  # commands of the mesh's own


def _command(kind, name: str):
    return _OWN.get(name) or getattr(kind, f"rank_{name}")


class Mesh:
    """Rank 0's end of the ranks: their processes and pipes, the watchdog,
    and rank 0's own ``ctx``."""

    def __init__(self, ranks: int, kind, device: str):
        self.kind = kind
        self.ctx = types.SimpleNamespace(rank=0, ranks=ranks, device=device)
        self.dir = tempfile.mkdtemp(prefix="bench_mesh_")
        init = f"file://{os.path.join(self.dir, 'rendezvous')}"
        cmd = [sys.executable, str(Path(__file__).resolve()), str(os.getpid()), init, str(ranks),
               Path(kind.__file__).stem, device]
        self.procs = [subprocess.Popen(cmd + [str(r)], stdin=subprocess.PIPE, stdout=subprocess.PIPE)
                      for r in range(1, ranks)]
        self.pending: list[tuple[str, float]] = []  # commands sent and not yet answered: (name, sent at)
        self.lags: dict[str, list[float]] = {}  # per command: seconds from rank 0's send to the last receipt
        self.waits: dict[str, list[float]] = {}  # per command: seconds rank 0 waited for answers after its own
        self._deadline: float | None = None
        self._what = ""
        self._stopping = False
        threading.Thread(target=self._watch, daemon=True).start()
        self._deadline, self._what = time.monotonic() + SETUP_S, "the rendezvous"
        _group(0, ranks, init, device)
        self._deadline = None

    def fail(self, why: str) -> None:
        """End the whole run: no rank survives, nothing more is printed."""
        print(f"benchmark: {why}; ending the run", file=sys.stderr, flush=True)
        for p in self.procs:
            p.kill()
        for p in self.procs:
            p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)
        os._exit(3)

    def _watch(self) -> None:
        while not self._stopping:
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None and not self._stopping:
                    self.fail(f"rank {r} exited with code {p.returncode}")
            if self._deadline is not None and time.monotonic() > self._deadline and not self._stopping:
                self.fail(f"{self._what} outlived its deadline")
            time.sleep(0.1)

    def send(self, name: str, *args, timeout: float | None = None) -> None:
        """Forward a command to ranks 1..R-1; its answers wait for ``collect``."""
        if self._deadline is None:
            self._deadline = time.monotonic() + (timeout or TIMEOUT_S)
            self._what = f"command {name!r}"
        data = pickle.dumps((name, args))
        for r, p in enumerate(self.procs, 1):
            try:
                p.stdin.write(data)
                p.stdin.flush()
            except OSError:
                self.fail(f"rank {r} ended before {name!r}")
        self.pending.append((name, time.perf_counter()))

    def collect(self) -> list:
        """The other ranks' answers to the oldest command not yet collected."""
        name, sent = self.pending.pop(0)
        out, received = [], []
        t0 = time.perf_counter()
        for r, p in enumerate(self.procs, 1):
            try:
                result, t_recv = pickle.load(p.stdout)
            except EOFError:
                self.fail(f"rank {r} ended without answering {name!r}")
            out.append(result)
            received.append(t_recv)
        self.lags.setdefault(name, []).append(max(received, default=sent) - sent)
        self.waits.setdefault(name, []).append(time.perf_counter() - t0)
        if not self.pending:
            self._deadline = None
        return out

    def call(self, name: str, *args, timeout: float | None = None) -> list:
        """Every rank's ``rank_<name>(ctx, *args)``, rank 0's here, in rank
        order (older commands' answers are collected first)."""
        self.send(name, *args, timeout=timeout)
        mine = _command(self.kind, name)(self.ctx, *args)
        while len(self.pending) > 1:
            self.collect()
        return [mine] + self.collect()

    def peak(self) -> int | None:
        """The largest of the ranks' peaks of device memory (None off the
        cards); every card's cached blocks are freed."""
        peaks = self.call("peak")
        print(f"peak memory by rank: {peaks} bytes", file=sys.stderr)
        return None if None in peaks else max(peaks)

    def forbidden(self) -> list[str]:
        """Modules of JAX or the JAX package loaded on ranks 1..R-1."""
        return [m for found in self.call("forbidden")[1:] for m in found]

    def report(self, *names: str) -> None:
        """On standard error, for each command named: how late the last of
        ranks 1..R-1 read it, and how long rank 0 then waited for their
        answers after its own."""
        def ms(xs):
            q = statistics.quantiles(xs, n=4) if len(xs) >= 2 else xs * 3
            return f"median {q[1] * 1e3:.3f} q3 {q[2] * 1e3:.3f} max {max(xs) * 1e3:.3f} ms"

        for name in names:
            if self.lags.get(name):
                print(f"mesh {name!r} over {len(self.lags[name])} calls: read by the last rank {ms(self.lags[name])} "
                      f"after the send; rank 0 waited {ms(self.waits[name])} for the answers", file=sys.stderr)

    def stop(self) -> None:
        """Stop every rank and wait for each; leave the process group."""
        import torch.distributed as dist

        global _ACTIVE
        if self._stopping:
            return
        self._stopping = True
        for p in self.procs:
            try:
                p.stdin.close()  # the end of its pipe: the rank leaves its group and exits
            except OSError:
                pass
        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        shutil.rmtree(self.dir, ignore_errors=True)
        if _ACTIVE is self:
            _ACTIVE = None


def start(ranks: int, kind, device: str) -> Mesh:
    """Ranks 1..ranks-1 for the job kind ``kind`` (a module loaded from its
    file), one group of ``ranks``; any mesh this process started before is
    stopped first."""
    global _ACTIVE
    if _ACTIVE is not None:
        _ACTIVE.stop()
    _ACTIVE = Mesh(ranks, kind, device)
    return _ACTIVE


def active() -> Mesh | None:
    """The mesh this process started and has not stopped, if any."""
    return _ACTIVE


@atexit.register
def _stop_at_exit() -> None:
    if _ACTIVE is not None:
        _ACTIVE.stop()


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when rank 0 ends (Linux's PR_SET_PDEATHSIG)."""
    import ctypes

    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:  # rank 0 ended before the signal was armed
        os._exit(3)


def _rank_main(parent: str, init: str, ranks: str, kind: str, device: str, rank: str) -> None:
    """A rank other than 0: join the group, then answer commands until the
    pipe from rank 0 ends.  A command that raises ends the rank (and,
    through rank 0's watchdog, the run)."""
    _die_with_parent(int(parent))
    commands, answers = sys.stdin.buffer, os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)  # anything the rank prints goes to standard error
    rank_i, ranks_i = int(rank), int(ranks)
    sys.path[0] = str(ROOT)
    import torch

    from benchmark import harness

    if not device.startswith("cuda"):
        torch.set_num_threads(1)
    kind = harness.load_module("jobs", kind, ROOT)
    _group(rank_i, ranks_i, init, device)
    ctx = types.SimpleNamespace(rank=rank_i, ranks=ranks_i, device=f"cuda:{rank_i}" if device.startswith("cuda")
                                else device)
    while True:
        try:
            name, args = pickle.load(commands)
        except EOFError:
            break
        t_recv = time.perf_counter()
        result = _command(kind, name)(ctx, *args)
        pickle.dump((result, t_recv), answers)
        answers.flush()
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
