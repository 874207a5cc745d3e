"""Field specs (the port's own, equal in value to ``zk_tpu.fields``'s); the
torch limb tier is ``zk_tpu_torch.fields.device``."""

from zk_tpu_torch.fields.field import LIMB_BITS, LIMB_MASK, Field  # noqa: F401

# Goldilocks p = 2^64 - 2^32 + 1
GOLDILOCKS = Field(name="Goldilocks", p=(1 << 64) - (1 << 32) + 1)

# BLS12-381 scalar field (ark-bls12-381 Fr), 255 bits
BLS12_381_FR = Field(
    name="BLS12-381-Fr",
    p=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
)

# BLS12-377 scalar field (ark-bls12-377 Fr), 253 bits
BLS12_377_FR = Field(
    name="BLS12-377-Fr",
    p=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
)
