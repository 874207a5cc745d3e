"""zk_tpu_torch — the sumcheck proving path on PyTorch and hand-written CUDA.

A port of ``zk_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
``zk_tpu`` stays the reference: the port gives the same canonical bytes,
the same Fiat-Shamir challenges, the same proofs and the same
accept/reject decisions.  Tables are (L, N) int32 tensors of 16-bit
Montgomery limbs, laid out as the reference's uint32 arrays.  Each TPU
kernel on the main path (MLE evaluation, sumcheck prove/verify) has a
CUDA kernel in ``csrc/`` with a plain torch version beside its wrapper;
CPU tensors take the plain versions, CUDA tensors the kernels.

This package imports torch and the JAX-free host modules of ``zk_tpu``
(field specs, host Keccak transcript, op counters) and never JAX.
Importing it builds nothing: the kernels are compiled with nvcc at first
use (``zk_tpu_torch._cuda``).
"""

from zk_tpu_torch.fields import BLS12_377_FR, BLS12_381_FR, GOLDILOCKS, Field  # noqa: F401
from zk_tpu_torch.poly.mle import MLE  # noqa: F401
from zk_tpu_torch.poly.product import ProductPoly  # noqa: F401
from zk_tpu_torch.sumcheck import (  # noqa: F401
    SubClaim,
    SumcheckError,
    SumcheckProof,
    SumcheckProver,
    SumcheckVerifier,
    proof_from_bytes,
    proof_to_bytes,
)
