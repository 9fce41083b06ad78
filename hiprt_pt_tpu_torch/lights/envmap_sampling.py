"""Environment lighting, mirroring ``hiprt_pt_tpu.lights.envmap_sampling``.

Only ``eval_envmap`` without an envmap texture is ported: the NONE and
UNIFORM ambient modes. Envmap textures and their importance sampling are on
the ROADMAP (item 8).
"""

from __future__ import annotations

import torch

from ..core.settings import AmbientLightType, WorldSettings


def eval_envmap(world: WorldSettings, envmap, d: torch.Tensor) -> torch.Tensor:
    """Radiance arriving from direction d (N,3) → (N,3)."""
    if envmap is not None:
        raise NotImplementedError(
            "envmap textures are not ported yet (ROADMAP: assets/envmap.py, "
            "lights/envmap_sampling.py)")
    n = d.shape[0]
    if world.ambient_light_type == int(AmbientLightType.UNIFORM):
        color = torch.as_tensor(world.uniform_light_color, dtype=torch.float32,
                                device=d.device)
        return color.expand(n, 3)
    return torch.zeros((n, 3), dtype=torch.float32, device=d.device)
