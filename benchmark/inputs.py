"""The benchmark's inputs, made on the device from the run's seed.

``random_elements`` is chip_smoke.py's ``main_table`` recipe (random
16-bit limbs, top limb masked to 0x1FFF, so every element is below p),
copied at the commit that added the benchmark.  The same seed gives the
same inputs on any device.
"""

from __future__ import annotations

import torch

TOP_MASK = 0x1FFF  # BLS12-381 Fr's top 16-bit limb is 0x73ED


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 64))


def random_elements(gen: torch.Generator, count: int, n: int, n_limbs: int = 16) -> torch.Tensor:
    """(count, n_limbs, n) int32 Montgomery limbs in one call on the
    generator's device."""
    t = torch.randint(0, 1 << 16, (count, n_limbs, n), generator=gen, device=gen.device, dtype=torch.int32)
    t[:, n_limbs - 1] &= TOP_MASK
    return t

