"""The photon pass: ``trace_photons`` then ``build_photon_map`` of the
program, map after map from one caller.

Traffic keys: ``photons`` (slots a map), ``ray_chunk`` (slots a chunk),
``depth`` (unused by the pass; the configuration's default chain depth
holds).  Map i is seeded by ``scene.seed_of(seed, i)``: the same number
of slots and chunks every time, drawn from another stream.

Set-up builds the scene and runs one pass of one chunk of each size the
maps use.  After the window one finished map, drawn from the seed, is
judged: its photons slot by slot against the reference's pass on the
same seed, and its grid exactly against the reference's grid of the
same photons.  The reference's pass also counts what K2 is given (the
rays of each trace), for its roofline.
"""

from __future__ import annotations

from ..core import scene as sc
from . import common


class State:
    pass


def _cfg(run, cls, seed):
    return common.render_config(cls, run.cell.traffic, seed)


def setup(run):
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons)
    s = State()
    s.scene = common.program_scene(run)
    s.cfg = _cfg(run, RenderConfig, run.seed)
    s.wmin = s.scene.world_min.cpu().numpy()
    s.wmax = s.scene.world_max.cpu().numpy()
    chunk, n = s.cfg.ray_chunk, s.cfg.photons
    warm = chunk + n % chunk if n > chunk and n % chunk else min(chunk, n)
    batch = trace_photons(s.scene, s.cfg.replace(
        photons=warm, seed=sc.seed_of(run.seed, -1)))
    build_photon_map(batch, s.wmin, s.wmax)
    s.maps = []
    s.run = run
    return s


def job(s, i: int) -> int:
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons)
    seed = sc.seed_of(s.run.seed, i)
    batch = trace_photons(s.scene, s.cfg.replace(seed=seed))
    with s.run.span("photon_grid"):
        pm = build_photon_map(batch, s.wmin, s.wmax)
    s.maps.append((seed, pm))
    return s.cfg.photons


def after_window(s, run):
    j = int(common.draw(run.seed, len(s.maps), 1, 2)[0])
    seed, pm = s.maps[j]
    run.work["tris"] = s.scene.n_tris
    return _answers(seed, pm)


def _answers(seed, pm):
    return {"seed": seed, "pm": common.batch_of_map(pm), "map": pm,
            "dir": common.in_slot_order(pm.dir, pm.order),
            "col": common.in_slot_order(pm.col, pm.order)}


def reference(run, ans=None):
    """The reference's batch of the judged map (of the control's seed
    without ``ans``), and the rays K2 is given on each trace of it."""
    seed = ans["seed"] if ans is not None else sc.seed_of(run.seed, 0)
    from ..ref import photon as ref_photon
    from ..ref.config import RenderConfig
    scene = common.ref_scene(run)
    launches = []
    orig = ref_photon.trace_closest

    def record(scene_, ro, *a, active=None, **kw):
        launches.append((ro.shape[0], active))
        return orig(scene_, ro, *a, active=active, **kw)
    ref_photon.trace_closest = record
    try:
        batch = ref_photon.trace_photons(scene, _cfg(run, RenderConfig, seed))
    finally:
        ref_photon.trace_closest = orig
    run.work["k2_launches"] = [(R, int(a.sum())) for R, a in launches]
    wmin = scene.world_min.cpu().numpy()
    wmax = scene.world_max.cpu().numpy()
    return {"batch": batch, "wmin": wmin, "wmax": wmax,
            "map": ref_photon.build_photon_map(batch, wmin, wmax)}


def compare(ans, ref) -> dict:
    """``photon_off``: the photons against the reference's batch;
    ``grid_off``: the map's grid against the reference's grid of the
    map's own photons (1 for another shape, else the share of cell
    ranges and sorted places that differ; 0 when they are equal)."""
    from ..ref.photon import PhotonBatch, build_photon_map
    b = ref["batch"]
    got = {"photon_off": common.photon_off(*ans["pm"], b.pos, b.stored)}
    pm = ans["map"]
    mine = build_photon_map(PhotonBatch(ans["pm"][0], ans["dir"], ans["col"],
                                        ans["pm"][1]), ref["wmin"],
                            ref["wmax"])
    if (tuple(mine.dims) != tuple(pm.dims)
            or mine.window_cap != pm.window_cap
            or mine.cell_start.shape != pm.cell_start.shape):
        got["grid_off"] = 1.0
    else:
        got["grid_off"] = max(
            float((mine.cell_start != pm.cell_start).float().mean()),
            float((mine.order != pm.order).float().mean()),
            float((mine.pos != pm.pos).any(-1).float().mean()))
    return got


def control(run):
    """The reference's pass in bfloat16 put in the program's place."""
    from ..ref import precision
    seed = sc.seed_of(run.seed, 0)
    with precision.bfloat16():
        low = reference(run)
    return _answers(seed, low["map"])

