"""Field specs, shared with the reference package (its field layer imports
no JAX); the torch limb tier is ``zk_tpu_torch.fields.device``."""

from zk_tpu.fields import BLS12_377_FR, BLS12_381_FR, GOLDILOCKS, Field  # noqa: F401
