"""Compiled scene containers (port of pbrt_tpu/scene/types.py, the slice's
part): the device tables, the static flags and the host specs."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.accel.traverse import KernelBVH
from pbrt_tpu_torch.core.sampling import Distribution1D

# tri_attr / slot_attr column layout (the reference's AT_*)
AT_P0, AT_P1, AT_P2 = 0, 3, 6   # vertices
AT_N = 9            # 9:18 per-vertex shading normals (zeros if none)
AT_UV = 18          # 18:24 per-vertex uv
AT_HASN = 24        # has shading normals (0/1)
AT_PRIM = 25        # primitive record id
AT_MAT = 26         # material id
AT_LIGHT = 27       # area light id or -1
AT_REV = 28         # reverse-orientation flag (0/1)
AT_TRI = 29         # original triangle id (-1 on padded slot rows)
AT_ALPHA = 30       # alpha-mask texture id (-1; masks are not ported)
AT_SALPHA = 31
AT_K = 32


@dataclasses.dataclass
class MaterialTable:
    kind: torch.Tensor    # [M] int32 (M_MATTE / M_PLASTIC)
    const: torch.Tensor   # [M, N_SLOTS, 3] constant slot values
    misc: torch.Tensor    # [M, 8]: eta, remaproughness, ...


@dataclasses.dataclass
class LightTable:
    kind: torch.Tensor    # [L] int32 (L_AREA / L_INFINITE)
    L: torch.Tensor       # [L,3] radiance, pre-scaled
    params: torch.Tensor  # [L,12] (lights/__init__.py layout)
    tri_cdf: torch.Tensor  # [C] per-light triangle area CDFs, concatenated
    ltri_p0: torch.Tensor  # [C,3] emitter triangles
    ltri_p1: torch.Tensor
    ltri_p2: torch.Tensor


@dataclasses.dataclass
class SceneData:
    tri_attr: torch.Tensor              # [T, AT_K]
    slot_attr: Optional[torch.Tensor]   # [L*8, AT_K] rows by leaf slot
    bvh: Optional[KernelBVH]            # None when the scene has no triangles
    mats: MaterialTable
    lights: LightTable
    light_distr: Distribution1D         # power-weighted light selection
    world_center: np.ndarray            # [3]
    world_radius: float


@dataclasses.dataclass(frozen=True)
class SceneFlags:
    n_tris: int
    n_lights: int
    has_infinite: bool
    has_area_lights: bool
    infinite_light_ids: Tuple[int, ...] = ()


@dataclasses.dataclass
class CompiledScene:
    data: SceneData
    flags: SceneFlags
    camera: object       # cameras.CameraSpec
    film: object         # film.FilmSpec
    sampler: object      # samplers.SamplerSpec
    integrator_kind: str
    integrator_params: dict

    @property
    def device(self):
        return self.data.tri_attr.device
