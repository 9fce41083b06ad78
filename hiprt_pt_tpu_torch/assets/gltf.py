"""Host-side parse result shared by the scene generators, mirroring
``hiprt_pt_tpu.assets.gltf.ParsedScene``. The GLTF importer itself is not
ported yet (ROADMAP, item 3)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.camera import Camera


@dataclass
class ParsedScene:
    """Host-side parse result, consumed by assets.scene.build_scene."""

    vertices: np.ndarray
    triangles: np.ndarray
    normals: Optional[np.ndarray]
    uvs: Optional[np.ndarray]
    material_ids: np.ndarray
    material_rows: list
    camera: Optional[Camera]
    images: list = field(default_factory=list)
