"""Flat SoA scene representation as dataclasses of torch tensors.

Counterpart of ``gi_raytracer_tpu.scene.types``: the same containers and
field names, with plain dataclasses in place of ``flax.struct``.
"""

from __future__ import annotations

import dataclasses

import torch

TEX_CONST = 0
TEX_CHECKER = 1
TEX_IMAGE = 2


def _to(obj, device):
    """Copy every tensor field of a dataclass to ``device``."""
    if obj is None:
        return None
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif dataclasses.is_dataclass(v):
            v = _to(v, device)
        kw[f.name] = v
    return type(obj)(**kw)


def dataclass_tensors(*objs) -> list:
    """Every tensor field of the given dataclasses (None skipped)."""
    return [v for o in objs if o is not None
            for v in (getattr(o, f.name) for f in dataclasses.fields(o))
            if isinstance(v, torch.Tensor)]


def derived(owner, name: str, sources, build):
    """``build()``, kept on ``owner`` under ``name``: the tables the kernels
    read (float32 copies, packed rows, boxes) are derived from tensors
    that a caller may replace or update in place (an optimizer step on a
    scene or map leaf), so the table is built again whenever a tensor of
    ``sources`` is another object or its version counter moved.  Other
    sources (a scene, a config) count by identity alone."""
    key = [(x, getattr(x, "_version", None)) for x in sources]
    kept = owner.__dict__.get(name)
    if kept is not None and len(kept[0]) == len(key) and all(
            a is b and va == vb for (a, va), (b, vb) in zip(kept[0], key)):
        return kept[1]
    value = build()
    owner.__dict__[name] = (key, value)
    return value


@dataclasses.dataclass
class Triangles:
    v0: torch.Tensor       # (T, 3)
    e1: torch.Tensor       # (T, 3) v1 - v0
    e2: torch.Tensor       # (T, 3) v2 - v0
    n0: torch.Tensor       # (T, 3) vertex normals (zero = use face normal)
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor      # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    face_n: torch.Tensor   # (T, 3) unit geometric normal
    mat_id: torch.Tensor   # (T,) int32

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass
class Spheres:
    pos: torch.Tensor      # (S, 3)
    rad: torch.Tensor      # (S,)
    mat_id: torch.Tensor   # (S,) int32

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass
class Cones:
    """Finite cones: apex on the local +z axis at ``height``, base disk of
    radius ``rad`` at z=0; ``w2l`` rotates world directions into the local
    frame (rays are moved into object space, not the cone)."""
    pos: torch.Tensor      # (C, 3) base center (world)
    rad: torch.Tensor      # (C,)
    height: torch.Tensor   # (C,)
    w2l: torch.Tensor      # (C, 3, 3) world->local rotation
    mat_id: torch.Tensor   # (C,) int32

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass
class Lights:
    pos: torch.Tensor      # (L, 3)
    col: torch.Tensor      # (L, 3)
    rad: torch.Tensor      # (L,)
    dir: torch.Tensor      # (L, 3) photon cone axis
    angle: torch.Tensor    # (L,) photon cone fraction in [0, 1]

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass
class Materials:
    diffuse_tex: torch.Tensor   # (M,) int32
    emissive_tex: torch.Tensor  # (M,) int32
    roughness: torch.Tensor     # (M,)
    opacity: torch.Tensor       # (M,)
    ior: torch.Tensor           # (M,)


@dataclasses.dataclass
class Textures:
    kind: torch.Tensor     # (K,) int32
    color: torch.Tensor    # (K, 3)
    color2: torch.Tensor   # (K, 3)
    tiles: torch.Tensor    # (K, 2)
    offset: torch.Tensor   # (K,) int32
    width: torch.Tensor    # (K,) int32
    height: torch.Tensor   # (K,) int32
    has_alpha: torch.Tensor  # (K,) bool
    atlas: torch.Tensor    # (N, 4)


@dataclasses.dataclass
class Fog:
    """Height fog: density ``density * noise(p)^7 * ((ymax - p.y)/size_y)^2``
    with ``noise`` trilinear in a uniform random grid."""
    bbox_min: torch.Tensor   # (3,)
    bbox_max: torch.Tensor   # (3,)
    color: torch.Tensor      # (3,)
    density: torch.Tensor    # () scalar
    scatter: torch.Tensor    # () scalar
    grid: torch.Tensor       # (nx, ny, nz) noise values in [0, 1)


@dataclasses.dataclass
class BVH:
    node_min: torch.Tensor   # (N, 3)
    node_max: torch.Tensor
    skip: torch.Tensor       # (N,) int32
    first: torch.Tensor      # (N,) int32
    count: torch.Tensor      # (N,) int32
    prim_idx: torch.Tensor   # (P,) int32
    leaf_size: int = 4

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]


@dataclasses.dataclass
class Scene:
    tris: Triangles
    spheres: Spheres
    cones: Cones | None
    lights: Lights
    materials: Materials
    textures: Textures
    bvh: BVH
    fog: Fog | None = None
    world_min: torch.Tensor = None
    world_max: torch.Tensor = None
    all_opaque: bool = False
    has_image_tex: bool = True

    @property
    def n_tris(self) -> int:
        return self.tris.count

    @property
    def n_spheres(self) -> int:
        return self.spheres.count

    @property
    def n_cones(self) -> int:
        return 0 if self.cones is None else self.cones.count

    @property
    def has_fog(self) -> bool:
        return self.fog is not None

    @property
    def device(self) -> torch.device:
        return self.tris.v0.device

    def to(self, device) -> "Scene":
        return _to(self, torch.device(device))

    def table_sources(self) -> list:
        """The tensors every table kept on the scene derives from: the
        triangles, spheres, cones, materials and textures."""
        return dataclass_tensors(self.tris, self.spheres, self.cones,
                                 self.materials, self.textures)
