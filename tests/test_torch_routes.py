"""Every choice of kernel, on the CPU: each decision of
``gi_raytracer_tpu_torch.routes`` with one case per reason it can give (on
stand-ins holding what it reads, and on the port's own scenes), the route a
CPU render's spans name, and the layering that keeps ``ops/`` below the
integrator and the photon pass.  (The kernels themselves run on the card
only: ``tests/test_torch_cuda.py``.)"""

import ast
import dataclasses
import pathlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gi_raytracer_tpu_torch import routes, telemetry
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.ops.cuda_wave_inputs import MAX_DEPTH
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.sampling.halton import HaltonSampler
from gi_raytracer_tpu_torch.sampling.rng import ThreefryUniform
from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
from gi_raytracer_tpu_torch.scene.cornell import (CAMERA_LOOK_AT, CAMERA_POS,
                                                  cornell_box)

OPS = pathlib.Path(routes.__file__).parent / "ops"
F32 = torch.zeros(0, dtype=torch.float32)
F64 = torch.zeros(0, dtype=torch.float64)
CARD = torch.device("cuda", 0)


def _scene(**kw):
    """A stand-in for an eligible 2,198-triangle scene on the card (every
    attribute a decision reads), with ``kw`` replaced."""
    lights = types.SimpleNamespace(count=1, pos=F32)
    s = dict(device=CARD, n_tris=2_198, n_spheres=0, n_cones=0,
             has_fog=False, has_image_tex=False, lights=lights,
             tris=types.SimpleNamespace(v0=F32))
    return types.SimpleNamespace(**dict(s, **kw))


@pytest.fixture(scope="module")
def built():
    """The port's own scenes on the CPU by name, each built once: the full
    Cornell box (2,198 triangles), the small box, the glass box past K2's
    rows and K1's cap (32,918) and the analytic box (spheres, a cone, an
    image texture); a stand-in passes through."""
    make = {"full": lambda: cornell_box(SceneBuilder, meshgen, True),
            "small": lambda: cornell_box(SceneBuilder, meshgen, False),
            "glass": lambda: cornell_box(SceneBuilder, meshgen, True, 6),
            "analytic": lambda: cornell_box(SceneBuilder, meshgen, False,
                                            analytic=True)}
    kept = {}

    def get(scene):
        if not isinstance(scene, str):
            return scene
        if scene not in kept:
            kept[scene] = make[scene]().build(device="cpu")
        return kept[scene]
    return get


# ---- the triangle trace -------------------------------------------------

@pytest.mark.parametrize("scene, want", [
    (_scene(), ("k2", [])),
    (_scene(n_tris=16_384), ("k2", [])),
    (_scene(n_tris=16_385), ("k4", ["16385 triangles > 16384"])),
    ("full", ("k2", [])),
    ("glass", ("k4", ["32918 triangles > 16384"]))],
    ids=["eligible", "at_the_cap", "past_the_cap", "cornell_full",
         "glass_32918"])
def test_trace_route_names_each_reason(built, scene, want):
    assert routes.trace(built(scene)) == want


# ---- the wave -------------------------------------------------------------

@pytest.mark.parametrize("scene, cfg, want", [
    (_scene(), {}, []),
    (_scene(), {"integrator": "mega"}, []),
    (_scene(), {"integrator": "staged"}, ["integrator 'staged'"]),
    (_scene(n_tris=0), {}, ["n_tris 0 not in (0, 24000]"]),
    (_scene(n_tris=24_001), {}, ["n_tris 24001 not in (0, 24000]"]),
    (_scene(n_spheres=2), {}, ["analytic prims (2 spheres, 0 cones)"]),
    (_scene(n_cones=1), {}, ["analytic prims (0 spheres, 1 cones)"]),
    (_scene(has_fog=True), {}, ["fog"]),
    (_scene(has_image_tex=True), {}, ["image textures"]),
    (_scene(lights=types.SimpleNamespace(count=5)), {}, ["5 lights > 4"]),
    (_scene(), {"dtype": "float64"}, ["dtype float64"]),
    (_scene(), {"max_depth": 17}, ["max_depth 17 > 16"]),
    ("full", {}, []),
    ("small", {"max_depth": 1}, []),
    ("glass", {"max_depth": 1}, ["n_tris 32918 not in (0, 24000]"]),
    ("analytic", {"max_depth": 4, "integrator": "staged"},
     ["integrator 'staged'", "analytic prims (2 spheres, 1 cones)",
      "image textures"])],
    ids=["eligible", "mega", "staged", "no_triangles", "past_the_cap",
         "spheres", "cones", "fog", "image_textures", "five_lights",
         "float64", "depth_17", "cornell_full", "cornell_small",
         "glass_32918", "analytic"])
def test_wave_route_names_each_reason(built, scene, cfg, want):
    cfg = RenderConfig(**dict(dict(max_depth=8, adaptive=False), **cfg))
    assert routes.wave(built(scene), cfg) == ("staged" if want else "k1",
                                               want)


def _lit(scene, col):
    return dataclasses.replace(scene, lights=dataclasses.replace(
        scene.lights, col=col))


GRAD_IN = ("the wave's inputs carry a gradient: autograd must see the "
           "operations")


@pytest.mark.parametrize("what", ["none", "light", "rays", "map",
                                  "no_grad_mode"])
def test_k1_refusal_names_a_gradient(built, what):
    """K1 is forward-only: a light, the rays or the map's photons that
    need a gradient refuse it, and only under grad mode."""
    scene = built("small")
    ro = torch.zeros((4, 3), requires_grad=what == "rays")
    pm = None
    if what == "map":
        col = torch.ones((3, 3), requires_grad=True)
        pm = types.SimpleNamespace(pos=F32, dir=F32, col=col)
    if what in ("light", "no_grad_mode"):
        scene = _lit(scene, scene.lights.col.clone().requires_grad_(True))
    with torch.set_grad_enabled(what != "no_grad_mode"):
        got = routes.k1_refusal(scene, ro, ro.detach(), pm)
    assert got == ([] if what in ("none", "no_grad_mode") else [GRAD_IN])


# ---- the wave's set-up ----------------------------------------------------

def _inputs_case(**kw):
    """What ``routes.wave_inputs`` reads of a card's renderer, with ``kw``
    replaced."""
    r = dict(device=CARD, cfg=RenderConfig(max_depth=8),
             camera=Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
             sampler=HaltonSampler())
    r.update(kw)
    return r["cfg"], r["device"], r["sampler"], r["camera"]


class _OtherSampler(HaltonSampler):
    pass


GRAD = "the camera carries a gradient: autograd must see the operations"


@pytest.mark.parametrize("kw, why", [
    ({}, []),
    ({"cfg": RenderConfig(max_depth=MAX_DEPTH)}, []),
    ({"device": torch.device("cpu")}, ["tensors on cpu, not the card"]),
    ({"cfg": RenderConfig(max_depth=8, dtype="float64")},
     ["dtype float64"]),
    ({"cfg": RenderConfig(max_depth=17)},
     ["max_depth 17 > 16: dims past Halton's arithmetic range"]),
    ({"sampler": _OtherSampler()},
     ["sampler _OtherSampler, not HaltonSampler"]),
    ({"camera": Camera(pos=torch.tensor(CAMERA_POS, requires_grad=True),
                       look_at=CAMERA_LOOK_AT)}, [GRAD]),
    ({"camera": Camera(pos=CAMERA_POS, look_at=tuple(
        torch.tensor(v, requires_grad=True) for v in CAMERA_LOOK_AT))},
     [GRAD])])
def test_wave_inputs_route_names_each_reason(kw, why):
    assert routes.wave_inputs(*_inputs_case(**kw)) == (
        "torch" if why else "kernel", why)


def test_a_camera_gradient_counts_only_under_grad_mode():
    cam = Camera(pos=torch.tensor(CAMERA_POS, requires_grad=True),
                 look_at=CAMERA_LOOK_AT)
    assert routes.wave_inputs(*_inputs_case(camera=cam))[1] == [GRAD]
    with torch.no_grad():
        assert routes.wave_inputs(*_inputs_case(camera=cam)) == ("kernel",
                                                                 [])


def test_cpu_render_decides_its_routes_once_a_frame(built):
    """A CPU render's ``wave.inputs`` spans carry ``route="torch"`` and its
    ``wave.trace`` spans ``"k1"`` (the staged wave standing in for K1);
    the frame keeps no camera constants (they are the kernel route's) and
    issues its waves eagerly (no CUDA graph on the CPU), and the set-up
    equals the plain version's."""
    box = built("small")
    cfg = RenderConfig(adaptive=False, min_samples=2, max_samples=2,
                       max_depth=2)
    r = Renderer(box, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 16, 16)
    assert r.frame_routes() == ("k1", "torch", None, "eager")
    telemetry.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            r.render()
        spans = telemetry.records()
    finally:
        telemetry.reset()
    assert [sp.attrs.get("route") for sp in spans
            if sp.name == "wave.inputs"] == ["torch", "torch"]
    assert [sp.attrs.get("route") for sp in spans
            if sp.name == "wave.trace"] == ["k1", "k1"]
    assert r._frame == ("k1", "torch", None, "eager")
    ro, rd, sx, sy = r.wave_inputs(1)
    for a, b in zip((ro, rd, sx, sy),
                    r.wave_inputs_plain(r.halton_index(1))):
        assert torch.equal(a, b)


# ---- the wave's issue: one CUDA graph or op by op -------------------------

def _graph_case(scene=None, route="staged", pm=None, device=CARD,
                inputs=()):
    return routes.wave_graph(scene or _scene(), route, pm, device, inputs)


MAP = types.SimpleNamespace(pos=F32, dir=F32, col=F32)


@pytest.mark.parametrize("kw, why", [
    ({}, None),
    ({"pm": MAP}, "a photon map: K3's work and totals are counted in "
                  "Python"),
    ({"route": "k1"}, "the k1 route"),
    ({"device": torch.device("cpu")}, "tensors on cpu, not the card"),
    ({"inputs": (torch.zeros(3, requires_grad=True),)},
     "the wave's inputs carry a gradient: autograd must see the "
     "operations"),
    ({"scene": _scene(has_fog=True)},
     "fog: a fog wave stays eager until the march's kernel is checked "
     "under the graph")],
    ids=["full_band", "with_a_map", "k1", "cpu", "grad", "fog"])
def test_wave_graph_route_names_each_reason(kw, why):
    """A frame of staged waves on the card replays the graph; each
    condition alone makes it eager, and the reason names it."""
    assert _graph_case(**kw) == (("replay", []) if why is None
                                 else ("eager", [why]))


def test_wave_graph_counts_a_gradient_only_under_grad_mode():
    leaf = [torch.zeros(3, requires_grad=True)]
    assert _graph_case(inputs=(leaf,))[0] == "eager"
    with torch.no_grad():
        assert _graph_case(inputs=(leaf,)) == ("replay", [])


def test_block_wave_replays_only_the_full_band(built, monkeypatch):
    """Where the frame's ``graph`` is ``"replay"``, a wave of the band's
    full lanes goes to ``replay_wave`` and a block wave of fewer lanes
    runs eagerly; each ``wave.trace`` span names which.  (On the CPU the
    frame never replays: the decision is forced here and ``replay_wave``
    stood in by the eager wave on the same lane ids.)"""
    from gi_raytracer_tpu_torch.render.integrator import radiance_wave
    box = built("small")
    cfg = RenderConfig(adaptive=False, min_samples=1, max_samples=1,
                       max_depth=2, integrator="staged")
    r = Renderer(box, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 32, 32)
    frame = r.frame_routes()._replace(graph="replay")
    replayed = []

    def replay(ro, rd, sx, sy, lane):
        replayed.append(ro.shape[0])
        return radiance_wave(box, cfg, ro, rd, sx, sy, 0, lane_ids=lane,
                             prim_rows=r.prim_rows())

    monkeypatch.setattr(r, "replay_wave", replay)
    telemetry.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            full, _ = r.block_wave(0, None, frame)
            part, _ = r.block_wave(0, torch.tensor([1]), frame)
        spans = [sp for sp in telemetry.records() if sp.name == "wave.trace"]
    finally:
        telemetry.reset()
    assert replayed == [32 * 32]
    assert [sp.attrs["graph"] for sp in spans] == ["replay", "eager"]
    want, _ = r.block_wave(0, None, r.frame_routes())
    assert torch.equal(full, want)
    # block 1 (block-major) is the band's rows 0-15, columns 16-31
    assert torch.equal(part[:16, 16:], want[:16, 16:])


def test_cpu_render_names_each_waves_issue(built):
    """A CPU render's ``wave.trace`` spans carry ``graph="eager"``, and
    the profile's rows name route and issue."""
    r = Renderer(built("analytic"), Camera(pos=CAMERA_POS,
                                           look_at=CAMERA_LOOK_AT),
                 RenderConfig(adaptive=False, min_samples=2, max_samples=2,
                              max_depth=2), 16, 16)
    telemetry.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            r.render()
        spans = [sp for sp in telemetry.records() if sp.name == "wave.trace"]
    finally:
        telemetry.reset()
    assert [telemetry.label(sp) for sp in spans] == [
        "wave.trace[staged, eager]"] * 2
    assert r._graph is None


def test_staged_wave_with_an_ambient_tensor_records_no_sync(built):
    """The staged wave on a triangle box, handed its ambient tensor, waits
    for nothing: under a profiler it records no ``sync`` span (the hash's
    integer keys are folded on the host), and it equals the wave that
    makes its own."""
    from gi_raytracer_tpu_torch.render.integrator import (ambient_tensor,
                                                          radiance_wave)
    box = built("small")
    cfg = RenderConfig(adaptive=False, min_samples=1, max_samples=1,
                       max_depth=3, ambient=(0.1, 0.2, 0.3))
    r = Renderer(box, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 16, 16)
    inputs = r.wave_inputs(0)
    amb = ambient_tensor(cfg, torch.float32, box.device)
    telemetry.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got, counts = radiance_wave(box, cfg, *inputs, 0, None,
                                        lane_base=256, ambient=amb)
        recs = telemetry.records()
    finally:
        telemetry.reset()
    assert [sp.attrs["site"] for sp in recs if sp.name == "sync"] == []
    want, wcounts = radiance_wave(box, cfg, *inputs, 0, None, lane_base=256)
    assert torch.equal(got, want)
    assert [int(c) for c in counts] == [int(c) for c in wcounts]


def test_renderer_keeps_its_ambient_tensor(built):
    """The staged waves' ambient tensor is made once a renderer: a second
    frame records no ``wave.ambient`` sync, and a new config makes it
    anew with the new values."""
    cfg = RenderConfig(adaptive=False, min_samples=1, max_samples=1,
                       max_depth=2, integrator="staged",
                       ambient=(0.1, 0.2, 0.3))
    r = Renderer(built("small"), Camera(pos=CAMERA_POS,
                                        look_at=CAMERA_LOOK_AT), cfg, 16, 16)
    r.render()
    amb = r.ambient()
    telemetry.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            r.render()
        sites = [sp.attrs["site"] for sp in telemetry.records()
                 if sp.name == "sync"]
    finally:
        telemetry.reset()
    assert "wave.ambient" not in sites and r.ambient() is amb
    r.cfg = cfg.replace(ambient=(0.5, 0.5, 0.5))
    assert r.ambient().tolist() == [0.5, 0.5, 0.5]


# ---- the fog march ---------------------------------------------------------

def _rays(device=CARD, dtype=torch.float32):
    """A stand-in for a march's rays: what ``routes.fog_march`` reads."""
    return types.SimpleNamespace(device=device, dtype=dtype)


def _fog(shape=(33, 17, 17), dtype=torch.float32):
    """A stand-in for the fog cell's fog, its noise grid of ``shape``."""
    return types.SimpleNamespace(grid=torch.zeros(shape, dtype=dtype),
                                 bbox_min=torch.zeros(3, dtype=dtype),
                                 density=torch.zeros((), dtype=dtype))


@pytest.mark.parametrize("kw, why", [
    ({}, None),
    ({"fog": _fog((38, 38, 40))}, None),
    ({"rays": _rays(torch.device("cpu"))}, "tensors on cpu, not the card"),
    ({"cfg": RenderConfig(dtype="float64"), "rays": _rays(dtype=F64.dtype),
      "fog": _fog(dtype=torch.float64)},
     "dtype float64 (['torch.float64'])"),
    ({"rays": _rays(dtype=F64.dtype)}, "dtype float32 (['torch.float64'])"),
    ({"fog": _fog((38, 38, 41))}, "a 38x38x41 noise grid: 236816 bytes > "
                                  "232448 of shared memory")],
    ids=["fog_cell", "at_the_cap", "cpu", "float64", "float64_rays",
         "past_shared_memory"])
def test_fog_march_route_names_each_reason(kw, why):
    """The fog cell's march on the card takes the kernel; each condition
    alone refuses it, and the reason names it."""
    rays = kw.get("rays", _rays())
    scene = _scene(has_fog=True, fog=kw.get("fog", _fog()))
    got = routes.fog_march(scene, kw.get("cfg", RenderConfig()), rays, rays)
    assert got == (("kernel", []) if why is None else ("torch", [why]))


def test_cpu_fog_render_marches_on_the_torch_route():
    """A CPU render of a fog box marches on ``_march``: every ``fog.march``
    span carries ``route="torch"`` and the plain version's calls count
    each march."""
    from gi_raytracer_tpu_torch.ops import _cuda
    b = cornell_box(SceneBuilder, meshgen, False)
    b.add_height_fog((4.0, 3.4, 0.0), (16.0, 8.0, 8.4), (1.0, 1.0, 1.0),
                     2.0, 0.5, 2)
    box = b.build(device="cpu")
    r = Renderer(box, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                 RenderConfig(adaptive=False, min_samples=1, max_samples=1,
                              max_depth=2), 8, 8)
    assert routes.fog_march(box, r.cfg, box.tris.v0, box.tris.v0) == (
        "torch", ["tensors on cpu, not the card"])
    _cuda.reset_launches()
    telemetry.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            r.render()
        spans = [sp for sp in telemetry.records() if sp.name == "fog.march"]
    finally:
        telemetry.reset()
    assert [sp.attrs["route"] for sp in spans] == ["torch"] * 4
    assert _cuda.plain_calls["fog_march"] == 4
    assert _cuda.launches["fog_march"] == 0


# ---- the photon round -----------------------------------------------------

def _eligible():
    """The arguments of an eligible pass on the card: a stand-in scene, a
    config, and the defaults."""
    return dict(scene=_scene(), cfg=RenderConfig(), sampler=None,
                uniform=None, differentiable=False)


class _Replay(ThreefryUniform):
    """Another uniform source (one that replays recorded draws)."""


def _with(scene=None, **changes):
    """A change to ``_eligible()``'s arguments: the scene's attributes
    replaced, other arguments replaced (a function: of the arguments)."""
    def apply(kw):
        if scene:
            kw["scene"] = _scene(**scene)
        for k, v in changes.items():
            kw[k] = v(kw) if isinstance(v, types.FunctionType) else v
        return kw
    return apply


ROUNDS = {
    "eligible": (_with(), None),
    "explicit_defaults": (_with(sampler=HaltonSampler(),
                                uniform=ThreefryUniform(5, "cpu")), None),
    "cpu": (_with(scene={"device": torch.device("cpu")}), "tensors on cpu"),
    "spheres": (_with(scene={"n_spheres": 2}), "analytic prims"),
    "cones": (_with(scene={"n_cones": 1}), "analytic prims"),
    "image_textures": (_with(scene={"has_image_tex": True}),
                       "image textures"),
    "past_k2_rows": (_with(scene={"n_tris": 16_385}), "16385 triangles"),
    "no_triangles": (_with(scene={"n_tris": 0}), "0 triangles"),
    "float64": (_with(cfg=lambda kw: kw["cfg"].replace(dtype="float64"),
                      scene={"lights": types.SimpleNamespace(pos=F64),
                             "tris": types.SimpleNamespace(v0=F64)}),
                "dtype float64"),
    "differentiable": (_with(differentiable=True), "differentiable"),
    "other_uniform": (_with(uniform=_Replay(0, "cpu")), "_Replay"),
    "other_sampler": (_with(sampler=_OtherSampler()), "_OtherSampler"),
    "deep_chain": (_with(cfg=lambda kw: kw["cfg"].replace(photon_depth=17)),
                   "photon_depth 17"),
}


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_photon_round_route_names_each_reason(case):
    """Each condition alone refuses the kernel, and the reason names it."""
    change, reason = ROUNDS[case]
    route, why = routes.photon_round(**change(_eligible()))
    if reason is None:
        assert (route, why) == ("k2", [])
    else:
        assert route == "staged" and len(why) == 1 and reason in why[0], why


# ---- the layering ---------------------------------------------------------

def _imports(path):
    """Every module ``path`` imports, relative imports made absolute."""
    pkg = "gi_raytracer_tpu_torch.ops"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = (pkg.rsplit(".", node.level - 1)[0] if node.level
                    else "")
            mod = ".".join(p for p in (base, node.module) if p)
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


def test_ops_imports_nothing_from_the_integrator_or_photon_pass():
    """No module under ``ops/`` imports ``render.integrator`` or
    ``render.photon``, at module level or inside a function: the kernels'
    wrappers sit below the code that chooses them."""
    mods = sorted(OPS.glob("*.py"))
    assert len(mods) >= 8
    banned = ("gi_raytracer_tpu_torch.render.integrator",
              "gi_raytracer_tpu_torch.render.photon")
    for path in mods:
        found = [m for m in _imports(path)
                 if m in banned or m.startswith(tuple(b + "." for b in banned))]
        assert not found, (path.name, found)
