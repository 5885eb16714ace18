"""Compiled scene containers (port of pbrt_tpu/scene/types.py, the slice's
part): the device tables, the static flags and the host specs."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.accel.instance import InstanceBVH
from pbrt_tpu_torch.accel.kdtree import KdTree
from pbrt_tpu_torch.accel.traverse import KernelBVH
from pbrt_tpu_torch.core.sampling import Distribution1D, Distribution2D
from pbrt_tpu_torch.textures import TextureTable

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
AT_ALPHA = 30       # alpha-mask texture id (-1: none)
AT_SALPHA = 31      # shadow-ray alpha-mask texture id
AT_K = 32


@dataclasses.dataclass
class MaterialTable:
    kind: torch.Tensor    # [M] int32 kind id (materials/__init__.py M_*)
    const: torch.Tensor   # [M, N_SLOTS, 3] constant slot values
    misc: torch.Tensor    # [M, 8]: eta, remaproughness, ...
    tex: torch.Tensor     # [M, N_SLOTS] int32 texture id of each slot (-1: its constant)
    child: Optional[torch.Tensor] = None   # [M, 2] int32 a mix's materials (-1: none)
    # BSSRDF rows (materials.compile_subsurface); None without subsurface materials
    sss: Optional[torch.Tensor] = None          # [M, 7] flag, sigma_t rgb, albedo rgb
    sss_prof: Optional[torch.Tensor] = None     # [M, 3, 64] profile rows
    sss_cdf: Optional[torch.Tensor] = None      # [M, 3, 64] their CDFs
    sss_rhoeff: Optional[torch.Tensor] = None   # [M, 3] effective albedos


@dataclasses.dataclass
class EnvMap:
    """The scene's environment map (one per scene, as in the reference)."""
    image: torch.Tensor        # [H, W, 3] equirect radiance
    distr: Distribution2D      # luminance * sin(theta) importance


@dataclasses.dataclass
class LightTable:
    """The light rows (lights/__init__.py) and kinds, the kind ids present,
    ascending, derived at construction."""
    kind: torch.Tensor    # [L] int32 kind id
    L: torch.Tensor       # [L,3] radiance, pre-scaled
    params: torch.Tensor  # [L,12] (lights/__init__.py layout)
    tri_cdf: torch.Tensor  # [C] per-light triangle area CDFs, concatenated
    ltri_p0: torch.Tensor  # [C,3] emitter triangles
    ltri_p1: torch.Tensor
    ltri_p2: torch.Tensor
    l2w: Optional[torch.Tensor] = None    # [L,4,4] light to world
    w2l: Optional[torch.Tensor] = None    # [L,4,4] world to light
    env: Optional[EnvMap] = None          # None: no infinite light has a map
    limg: Optional[torch.Tensor] = None   # [K,64,64,3] projection / goniometric maps
    mapped: Tuple[int, ...] = ()          # rows of the infinite lights with a map
    w2l_host: Optional[np.ndarray] = None  # w2l on the host
    medium: Optional[torch.Tensor] = None  # [L] int32 the outside medium at declaration
    kinds: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        self.kinds = tuple(int(k) for k in np.unique(self.kind.cpu().numpy()))


@dataclasses.dataclass
class QuadricTable:
    """The scene's quadrics, one row each (shapes/quadrics.py), and by_kind:
    {kind: (its rows ascending [Qk] int64, their w2o [Qk,4,4], params
    [Qk,8])}, derived at construction for the quadric pass."""
    kind: torch.Tensor      # [Q] int32 kind id
    o2w: torch.Tensor       # [Q,4,4] object to world
    w2o: torch.Tensor       # [Q,4,4] world to object
    params: torch.Tensor    # [Q,8]
    prim: torch.Tensor      # [Q] int32 primitive record id
    material: torch.Tensor  # [Q] int32 material id
    light: torch.Tensor     # [Q] int32 area light id or -1
    rev: torch.Tensor       # [Q] bool reverse orientation
    by_kind: dict = dataclasses.field(init=False)

    def __post_init__(self):
        kinds = self.kind.cpu().numpy()
        self.by_kind = {}
        for k in np.unique(kinds):
            rows = torch.as_tensor(np.nonzero(kinds == k)[0], device=self.kind.device)
            self.by_kind[int(k)] = (rows, self.w2o[rows], self.params[rows])


@dataclasses.dataclass
class SceneData:
    tri_attr: torch.Tensor              # [T, AT_K]: world rows, then prototype rows
    slot_attr: Optional[torch.Tensor]   # [L*8, AT_K] rows by leaf slot
    bvh: Optional[KernelBVH]            # over the world rows; None without any
    mats: MaterialTable
    tex: TextureTable
    lights: LightTable
    light_distr: Distribution1D         # power-weighted light selection
    world_center: np.ndarray            # [3]
    world_radius: float
    ibvh: Optional[InstanceBVH] = None  # the instance world; None without instances
    quads: Optional[QuadricTable] = None  # None without quadrics
    fourier: object = None                # FourierTable; None without fourier materials
    light_spatial: object = None          # SpatialLightDistrib of the "spatial" strategy
    prim_medium: Optional[torch.Tensor] = None  # [P,2] int32 (inside, outside) medium, -1 vacuum
    media: object = None                  # media.MediumTable
    camera_medium: int = -1               # the camera's medium (-1: vacuum)
    kd: Optional[KdTree] = None           # the world kd-tree under Accelerator "kdtree"


@dataclasses.dataclass(frozen=True)
class SceneFlags:
    n_tris: int                  # world triangles (rows the world BVH covers)
    n_lights: int
    has_infinite: bool
    has_area_lights: bool
    infinite_light_ids: Tuple[int, ...] = ()
    n_instances: int = 0
    n_world_tris: int = 0        # tri_attr rows before the prototype rows
    any_animated_inst: bool = False
    n_quadrics: int = 0
    tex_kinds: Tuple[int, ...] = ()      # texture kind ids in the table, ascending
    has_tex_slot: Tuple[bool, ...] = ()  # per material slot: some material textures it
    has_alpha: bool = False              # some triangle has an alpha mask
    alpha_kinds: Tuple[int, ...] = ()    # texture kinds the alpha masks reach
    # the reference's material_families: (diffuse transmission, glossy,
    # glossy transmission, Oren-Nayar, specular)
    bsdf_fams: Tuple[bool, ...] = (True, True, True, True, True)
    mat_kinds: Tuple[int, ...] = ()      # material kind ids in the table, ascending
    has_fourier: bool = False
    light_strategy: str = "power"        # "power", "uniform" or "spatial"
    n_media: int = 0                     # named media
    any_grid_media: bool = False
    accel: str = "bvh"                   # the world walk: "bvh" or "kdtree"
    has_subsurface: bool = False         # some material is subsurface or kdsubsurface
    # sampled-spectrum mode (Integrator ... "bool spectral" "true"): colours
    # widen to N_SPECTRAL_SAMPLES channels at the material and light
    # boundaries of path and directlighting (core/spectrum.py)
    spectral: bool = False


@dataclasses.dataclass
class CompiledScene:
    data: SceneData
    flags: SceneFlags
    camera: object       # cameras.CameraSpec
    film: object         # film.FilmSpec
    sampler: object      # samplers.SamplerSpec
    integrator_kind: str
    integrator_params: dict
    # how to load the scene again on another rank of a sharded render:
    # (loader, args, kwargs), the loader called with device= as well;
    # None for a scene built from a description in memory
    source: Optional[tuple] = None

    @property
    def device(self):
        return self.data.tri_attr.device
