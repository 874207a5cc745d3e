"""Fiat-Shamir transcript: the host Keccak-256 transcript is the reference
package's (JAX-free; C backend when built), re-exported here; the
device-resident sponge is ``zk_tpu_torch.transcript.device``."""

from zk_tpu.transcript import HAS_NATIVE, Transcript  # noqa: F401
