"""The port's tracing: named spans at its layer boundaries, and its one
device -> host read.

``span(name)`` is a ``torch.profiler.record_function`` range while a
``torch.profiler`` records, and one shared no-op context otherwise, after a
single check.  The spans nest on the thread (parent and child come from
nesting), stay in the profiler's memory and share its clock with the device
trace; they leave the process only through whoever owns the profiler.

``to_host(t)`` reads a tensor back inside a ``zk.sync`` span, so a profile
counts every host sync and times its wait for the device's queue.

The spans:

  zk.prove                  a sumcheck prove (SumcheckProver)
  zk.prove.start            the stack (a fresh copy for a product), the round record's plan, the sponge's upload
  zk.prove.round            one round queued (a synced round: with its read-back)
  zk.prove.decode           the read-back round record as ints, the sponge restored; the host tail
  zk.sync                   one device -> host read, its wait included
  zk.proof.to_bytes / zk.proof.from_bytes   serialisation
  zk.verify                 the sumcheck verifier's round checks
  zk.mle.evaluate           MLE.evaluate: the folds and the read-back
  zk.gkr.*                  the GKR provers' stages
  zk.build                  a kernel library compiled (nvcc, or cc for the host Keccak)
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

_OFF = nullcontext()


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    shared no-op context."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: the port's one way to read a tensor back."""
    with span("zk.sync"):
        return t.cpu()
