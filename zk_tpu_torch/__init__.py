"""zk_tpu_torch — sumcheck, GKR and NTT on PyTorch and hand-written CUDA.

A port of ``zk_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
``zk_tpu`` stays the reference: the port gives the same canonical bytes,
the same Fiat-Shamir challenges, the same proofs and the same
accept/reject decisions.  Tables are (L, N) int32 tensors of 16-bit
Montgomery limbs, laid out as the reference's uint32 arrays.  Each TPU
kernel on the ported paths (MLE evaluation, sumcheck prove/verify, the
GKR layer chain, the NTT and large univariate products) has a CUDA
kernel in ``csrc/`` with a plain torch version beside its wrapper; CPU
tensors take the plain versions, CUDA tensors the kernels.  Entry points
put their tensors on the card unless the caller names another device
(``device="cpu"``).  The package exports the transforms ``ntt``/``intt``,
so its ``ntt`` attribute is that function; the module is
``importlib.import_module("zk_tpu_torch.ntt")`` (or ``from
zk_tpu_torch.ntt import ...``).

``zk_tpu_torch.parallel`` runs the sumcheck prover, the NTT and the GKR
prover sharded over a ``torch.distributed`` mesh, with the same proofs.

This package imports torch and numpy and nothing of ``zk_tpu`` or JAX.
Importing it builds nothing: the kernels are compiled with nvcc at first
use (``zk_tpu_torch._cuda``), the host Keccak with the C compiler at the
first transcript (``zk_tpu_torch.transcript.native``).
"""

from zk_tpu_torch.fields import BLS12_377_FR, BLS12_381_FR, GOLDILOCKS, Field  # noqa: F401
from zk_tpu_torch.gkr import GKRProver, GKRVerifier  # noqa: F401
from zk_tpu_torch.gkr.circuit import Circuit  # noqa: F401
from zk_tpu_torch.ntt import intt, intt_device, ntt, ntt_device  # noqa: F401
from zk_tpu_torch.poly.mle import MLE  # noqa: F401
from zk_tpu_torch.poly.product import ProductPoly, SumOfProducts  # noqa: F401
from zk_tpu_torch.poly.univariate import UnivariatePolynomial  # noqa: F401
from zk_tpu_torch.sumcheck import (  # noqa: F401
    SubClaim,
    SumcheckError,
    SumcheckProof,
    SumcheckProver,
    SumcheckVerifier,
    proof_from_bytes,
    proof_to_bytes,
)
