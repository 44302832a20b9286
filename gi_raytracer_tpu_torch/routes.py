"""Which code serves each job of the port: every choice of kernel, made here.

A route is the code that serves a job: a CUDA kernel or the torch code that
is its plain version.  Each decision returns ``(route, why)``, the reasons
the kernel was refused (empty where it runs); the conditions the decisions
share are written once, and the kernels' limits they read are here.  This
module imports nothing from ``render/``.
"""

from __future__ import annotations

import dataclasses

import torch

from .ops import cuda_fog, cuda_wave_inputs
from .sampling.halton import HaltonSampler
from .sampling.rng import ThreefryUniform
from .scene.types import dataclass_tensors

# the JAX package's names for the sizes past which a scene's queries go to
# K4's superchunks instead of K2's 128-row chunks, and its waves to the
# staged wave instead of K1 (a cap copied from the TPU's VMEM budget); K1's
# depth and lights (megakernel.cu keeps a wave's state in registers) and a
# photon round's chain steps (photon.cu's GI_PHOTON_MAX_DEPTH)
VMEM_TRI_CAP = 16_384
MEGA_TRI_CAP = 24_000
MEGA_MAX_DEPTH, MEGA_MAX_LIGHTS = 16, 4
PHOTON_MAX_DEPTH = 16


def _grad(wanted: bool, what: str) -> list:
    return [f"{what}: autograd must see the operations"] if wanted else []


def _wants_grad(*values) -> bool:
    """Grad mode on, and a tensor among ``values`` (or in their tuples and
    lists) requiring a gradient."""
    def needs(v):
        if torch.is_tensor(v):
            return v.requires_grad
        return isinstance(v, (tuple, list)) and any(map(needs, v))
    return torch.is_grad_enabled() and any(map(needs, values))


def _on_card(device) -> list:
    return ([] if device.type == "cuda"
            else [f"tensors on {device.type}, not the card"])


def _float32(cfg, *tensors) -> list:
    dts = sorted({str(t.dtype) for t in tensors} - {"torch.float32"})
    if cfg.dtype == "float32" and not dts:
        return []
    return [f"dtype {cfg.dtype}" + (f" ({dts})" if dts else "")]


def _triangles_only(scene) -> list:
    """No analytic prims and no image textures."""
    why = ([f"analytic prims ({scene.n_spheres} spheres, {scene.n_cones} "
            f"cones)"] if scene.n_spheres or scene.n_cones else [])
    return why + (["image textures"] if scene.has_image_tex else [])


def _default_sources(sampler, uniform=None) -> list:
    """``sampler``/``uniform`` None stand for the defaults."""
    why = []
    if sampler is not None and type(sampler) is not HaltonSampler:
        why.append(f"sampler {type(sampler).__name__}, not HaltonSampler")
    if uniform is not None and type(uniform) is not ThreefryUniform:
        why.append(f"emission uniforms from {type(uniform).__name__}, not "
                   f"ThreefryUniform")
    return why


def trace(scene) -> tuple:
    """A triangle query: ``"k2"`` (``ops.cuda_intersect``) or, past
    ``VMEM_TRI_CAP`` triangles, ``"k4"`` (``ops.cuda_stream``); each its
    kernel on the card and its plain walk on the CPU."""
    if scene.n_tris > VMEM_TRI_CAP:
        return "k4", [f"{scene.n_tris} triangles > {VMEM_TRI_CAP}"]
    return "k2", []


def wave(scene, cfg) -> tuple:
    """A render wave: ``"k1"`` (``ops.cuda_megakernel``, whose plain version
    on CPU tensors is the staged wave) where the ``integrator`` field is
    "auto" or "mega" and the scene is in K1's scope, else ``"staged"``
    (``render.integrator.radiance_wave``).  K1's wrapper refuses the
    same."""
    why = ([] if cfg.integrator in ("auto", "mega")
           else [f"integrator {cfg.integrator!r}"])
    if not 0 < scene.n_tris <= MEGA_TRI_CAP:
        why.append(f"n_tris {scene.n_tris} not in (0, {MEGA_TRI_CAP}]")
    why += _triangles_only(scene) + (["fog"] if scene.has_fog else [])
    if scene.lights.count > MEGA_MAX_LIGHTS:
        why.append(f"{scene.lights.count} lights > {MEGA_MAX_LIGHTS}")
    why += _float32(cfg)
    if cfg.max_depth > MEGA_MAX_DEPTH:
        why.append(f"max_depth {cfg.max_depth} > {MEGA_MAX_DEPTH}")
    return ("staged" if why else "k1"), why


def k1_refusal(scene, ro, rd, photon_map) -> list:
    """What refuses a wave's tensors on K1's route (K1 is forward-only): a
    gradient through the scene's tables or lights, the rays or the map."""
    pm = () if photon_map is None else (photon_map.pos, photon_map.dir,
                                        photon_map.col)
    return _grad(_wants_grad(scene.table_sources(),
                             dataclass_tensors(scene.lights), ro, rd, pm),
                 "the wave's inputs carry a gradient")


def wave_graph(scene, route, photon_map, device, inputs=()) -> tuple:
    """A frame's issue of its full-band waves: ``"replay"``, one CUDA graph
    of the staged wave over the renderer's full band, captured once and
    replayed (``render.integrator.WaveGraph``), or ``"eager"``, its
    operations issued one by one.  A captured wave may not wait for the
    host or copy host numbers to the card, and runs no Python when
    replayed.  ``route`` is ``wave``'s; ``inputs``: the tensors a gradient
    could come through.  Decided once a frame (``Renderer.start``); a
    wave of fewer lanes than the band's is eager whatever this says (an
    adaptive frame's block counts repeat only where the same frame is
    rendered again)."""
    why = [] if route == "staged" else [f"the {route} route"]
    why += _on_card(device) + _grad(_wants_grad(*inputs),
                                    "the wave's inputs carry a gradient")
    if scene.has_fog:
        why.append("fog: a fog wave stays eager until the march's kernel "
                   "is checked under the graph")
    if photon_map is not None:
        why.append("a photon map: K3's work and totals are counted in "
                   "Python")
    return ("eager" if why else "replay"), why


def wave_inputs(cfg, device, sampler, camera) -> tuple:
    """A wave's Halton dims and primary rays: ``"kernel"``
    (``ops.cuda_wave_inputs``) or ``"torch"``."""
    why = _on_card(device) + _float32(cfg)
    if cfg.max_depth > cuda_wave_inputs.MAX_DEPTH:
        why.append(f"max_depth {cfg.max_depth} > "
                   f"{cuda_wave_inputs.MAX_DEPTH}: dims past Halton's "
                   f"arithmetic range")
    why += _default_sources(sampler) + _grad(
        _wants_grad(*(getattr(camera, f.name)
                      for f in dataclasses.fields(camera))),
        "the camera carries a gradient")
    return ("torch" if why else "kernel"), why


def photon_round(scene, cfg, sampler, uniform, differentiable) -> tuple:
    """A photon pass's retry rounds: ``"k2"`` (the photon-round policy of
    K2's walk kernel, ``ops.cuda_photon``) or ``"staged"``."""
    why = _on_card(scene.device) + _triangles_only(scene) + trace(scene)[1]
    if not scene.n_tris:
        why.append("0 triangles: nothing for K2 to walk")
    why += _float32(cfg, scene.lights.pos, scene.tris.v0)
    why += _grad(differentiable, "differentiable")
    why += _default_sources(sampler, uniform)
    if cfg.photon_depth > PHOTON_MAX_DEPTH:
        why.append(f"photon_depth {cfg.photon_depth} > "
                   f"{PHOTON_MAX_DEPTH}")
    return ("staged" if why else "k2"), why


def fog_march(scene, cfg, ro, rd) -> tuple:
    """A march through the scene's fog: ``"kernel"`` (``ops.cuda_fog``, a
    thread a lane) or ``"torch"`` (``render.atmosphere._march``).  A
    gradient through the rays is no refusal: the caller rebuilds t from
    the kernel's step index in torch."""
    fog = scene.fog
    why = _on_card(ro.device) + _float32(cfg, ro, rd, fog.grid,
                                         fog.bbox_min, fog.density)
    nbytes = 4 * fog.grid.numel()
    if nbytes > cuda_fog.MAX_GRID_BYTES:
        why.append(f"a {'x'.join(map(str, fog.grid.shape))} noise grid: "
                   f"{nbytes} bytes > {cuda_fog.MAX_GRID_BYTES} of shared "
                   f"memory")
    return ("torch" if why else "kernel"), why
