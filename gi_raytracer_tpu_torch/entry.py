"""Entry points of the port, the counterparts of the root
``__graft_entry__.py``:

* ``entry()`` -> (fn, example_args): one radiance wave of the tiny
  Cornell-style scene (five diffuse walls, a glass sphere, an area light)
  at 64x64, depth 4; ``fn(*example_args)`` returns its (R, 3) radiance.
* ``dryrun_multichip(n)``: the distributed pipeline on n ranks of a
  process group (``parallel.mesh``): the photon pass sharded over slots
  and the map built from the gathered batch; the adaptive render sharded
  by rows, asserted equal (max error under 1e-5) to the single-process
  render; one sharded train step, asserted finite.  The ranks share the
  card over gloo (or take a card each over NCCL), or run on the CPU over
  gloo with ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from .config import RenderConfig
from .render.camera import Camera

CAMERA = dict(pos=(0.0, 0.0, -14.0), look_at=(0.0, 0.0, 0.0))


def tiny_scene(dtype=torch.float32, device="cuda"):
    """The self-contained Cornell-style box: 5 diffuse walls, a glass
    sphere and an area light."""
    from .scene import SceneBuilder
    from .scene.meshgen import quad_mesh

    b = SceneBuilder()
    white = b.add_texture_const((0.9, 0.9, 0.9))
    red = b.add_texture_const((0.8, 0.2, 0.2))
    blue = b.add_texture_const((0.2, 0.2, 0.8))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    m_white = b.add_material(white, black, 1.0, 1.0, 1.0)
    m_red = b.add_material(red, black, 1.0, 1.0, 1.0)
    m_blue = b.add_material(blue, black, 1.0, 1.0, 1.0)
    m_glass = b.add_material(white, black, 0.0, 0.0, 1.5)
    s = 4.0
    for quad, mat in (
            (((-s, -s, -s), (s, -s, -s), (-s, -s, s), (s, -s, s)), m_white),
            (((-s, s, -s), (s, s, -s), (-s, s, s), (s, s, s)), m_white),
            (((-s, -s, s), (s, -s, s), (-s, s, s), (s, s, s)), m_white),
            (((-s, -s, -s), (-s, -s, s), (-s, s, -s), (-s, s, s)), m_red),
            (((s, -s, s), (s, -s, -s), (s, s, s), (s, s, -s)), m_blue)):
        b.add_triangles(quad_mesh(*quad), mat_id=mat)
    b.add_sphere((0.0, -2.0, 0.0), 1.2, m_glass)
    b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
    return b.build(dtype=dtype, device=device)


def entry(device="cuda"):
    """(fn, example_args): ``fn(scene, ro, rd, sx_all, sy_all)`` is one
    staged radiance wave of the tiny scene at 64x64, depth 4."""
    from .render.integrator import Renderer, radiance_wave

    scene = tiny_scene(device=device)
    cfg = RenderConfig(min_samples=1, max_samples=1, max_depth=4)
    r = Renderer(scene, Camera(**CAMERA), cfg, 64, 64)

    def fn(scene, ro, rd, sx_all, sy_all):
        return radiance_wave(scene, cfg, ro, rd, sx_all, sy_all, 0, None)[0]

    return fn, (scene, *r.wave_inputs(0))


def _dryrun_rank(mesh, n):
    """One rank of ``dryrun_multichip``: (photon batch, render state,
    train step loss and parameters), as CPU tensors."""
    import dataclasses

    from .parallel.mesh import render_fused_sharded, train_step_sharded
    from .render.integrator import Renderer
    from .render.photon import build_photon_map, trace_photons_sharded

    scene = tiny_scene(device=mesh.device)
    cfg = _dryrun_config(n)
    batch = trace_photons_sharded(scene, cfg, mesh)
    pm = build_photon_map(batch, scene.world_min.cpu().numpy(),
                          scene.world_max.cpu().numpy())
    side = max(64, 16 * n)
    r = Renderer(scene, Camera(**CAMERA), cfg, side, side, photon_map=pm)
    st = render_fused_sharded(r, mesh)

    ro, rd, sx, sy = r.wave_inputs(0)
    params = {"light_col": scene.lights.col, "tex_color": scene.textures.color}

    def rebuild(p):
        return dataclasses.replace(
            scene, lights=dataclasses.replace(scene.lights,
                                              col=p["light_col"]),
            textures=dataclasses.replace(scene.textures,
                                         color=p["tex_color"])), None

    loss, new = train_step_sharded(mesh, params, rebuild, cfg, ro, rd, sx, sy,
                                   torch.zeros_like(ro))
    cpu = {k: v.cpu() for k, v in new.items()}
    return ([t.cpu() for t in batch], {k: v.cpu() if torch.is_tensor(v)
                                       else v for k, v in st.items()},
            float(loss), cpu)


def _dryrun_config(n: int) -> RenderConfig:
    return RenderConfig(min_samples=2, max_samples=4, max_depth=3,
                        photons=n * 32, photon_retries=8)


def dryrun_multichip(n_devices: int, device="cuda",
                     threads: int | None = None) -> None:
    """The distributed pipeline on ``n_devices`` local ranks: the sharded
    photon pass (every rank's batch equal), the whole adaptive render
    sharded by rows against the single-process render (max error under
    1e-5, equal ray count) and one sharded train step (finite loss and
    parameters, equal on every rank).  ``threads``: torch's intra-op
    threads a rank.  Raises on any failure."""
    from .parallel.mesh import run_ranks
    from .render.integrator import Renderer
    from .render.photon import PhotonBatch, build_photon_map

    def check(ok, what):
        if not ok:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {what}")

    out = run_ranks(_dryrun_rank, n_devices, n_devices, device=device,
                    threads=threads)
    batch0, st0, loss0, new0 = out[0]
    for batch, st, loss, new in out[1:]:
        check(all(torch.equal(a, b) for a, b in zip(batch, batch0))
              and torch.equal(st["mean"], st0["mean"]) and loss == loss0
              and all(torch.equal(new[k], new0[k]) for k in new0),
              "ranks disagree")
    scene = tiny_scene(device=device)
    cfg = _dryrun_config(n_devices)
    batch = PhotonBatch(*(t.to(scene.device) for t in batch0))
    stored = int(batch.stored.sum())
    pm = build_photon_map(batch, scene.world_min.cpu().numpy(),
                          scene.world_max.cpu().numpy())
    side = max(64, 16 * n_devices)
    img, st = Renderer(scene, Camera(**CAMERA), cfg, side, side,
                       photon_map=pm).render(return_state=True)
    err = float((st0["mean"] - img.cpu()).abs().max())
    check(err < 1e-5, f"sharded render mismatch: max err {err}")
    check(torch.isfinite(st0["mean"]).all(), "non-finite image")
    rays = float(st0["rays"])
    check(rays > 0 and rays == float(st["rays"]),
          f"rays {rays} against {float(st['rays'])}")
    check(math.isfinite(loss0), f"non-finite loss {loss0}")
    for k, v in new0.items():
        check(torch.isfinite(v).all(), f"non-finite update for {k}")
    print(f"dryrun_multichip({n_devices}): photons={stored} "
          f"render_err={err:.2e} rays={rays:.0f} loss={loss0:.6f} ok")
