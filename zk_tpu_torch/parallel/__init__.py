"""Multi-device execution over ``torch.distributed``: the mesh, and the
sharded sumcheck prover, NTT and GKR witness.

Counterpart of ``zk_tpu.parallel``, with the same strategies:

  * a hypercube table shards like a long sequence axis: its flat index is
    viewed as (W, D) with the D axis split across the mesh, so the fold of
    variable 0 (the most significant bit) stays on each rank until the
    local table is small;
  * round sums are per-rank partial sums and one ``all_reduce`` a round;
  * the 4-step NTT exchanges its middle transpose with one
    ``all_to_all_single``;
  * the GKR witness is gate-sharded, one ``all_gather`` a layer.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over an
initialised process group (NCCL on the card, gloo on the CPU).  A mesh of
several dimensions (the reference's ("dcn", "ici") mesh) runs its
collectives over all of its ranks in row-major order (``DeviceMesh.
_flatten``).  A rank's shard index is its rank in that group.  Every rank
of the mesh calls the sharded entry points with the same arguments, and
each returns the same proof; a failing collective raises on the rank that
sees it.
"""

from zk_tpu_torch.parallel.mesh import COLLECTIVES, MeshGroup, collectives, make_mesh, reset_collectives  # noqa: F401
from zk_tpu_torch.parallel.ntt import gather_natural, ntt_sharded  # noqa: F401
from zk_tpu_torch.parallel.sumcheck import ShardedStack, ShardedSumcheckProver  # noqa: F401
