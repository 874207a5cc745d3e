"""Field specs (the port's own, equal in value to ``zk_tpu.fields``'s); the
torch limb tier is ``zk_tpu_torch.fields.device``, the elementwise CUDA
kernels ``zk_tpu_torch.fields.kernels``."""

from zk_tpu_torch.fields.field import LIMB_BITS, LIMB_MASK, Field  # noqa: F401

# 17-element test field: modulus 17, generator 3 (univariate_poly.rs:237-241).
# One 16-bit limb: it runs on the plain torch tier only (the CUDA kernels
# take 4- and 16-limb fields).
F17 = Field(name="F17", p=17, generator=3)

# Goldilocks p = 2^64 - 2^32 + 1, generator 7, 2-adicity 32
GOLDILOCKS = Field(name="Goldilocks", p=(1 << 64) - (1 << 32) + 1, generator=7)

# BLS12-381 scalar field (ark-bls12-381 Fr): 255 bits, generator 7, 2-adicity 32
BLS12_381_FR = Field(
    name="BLS12-381-Fr",
    p=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
)

# BLS12-377 scalar field (ark-bls12-377 Fr): 253 bits, generator 22, 2-adicity 47
BLS12_377_FR = Field(
    name="BLS12-377-Fr",
    p=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    generator=22,
)

ALL_FIELDS = (F17, GOLDILOCKS, BLS12_381_FR, BLS12_377_FR)
