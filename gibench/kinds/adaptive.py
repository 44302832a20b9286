"""The adaptive frame: one ``Renderer.render()`` of the program to the
finished image under the adaptive sampler (``adaptive=True``: each wave
traces the 16x16 blocks that still hold an active pixel), frame after
frame from one caller.

Traffic keys: ``width``, ``height``, ``min_spp``, ``max_spp``,
``noise_thresh``, ``depth``, ``knn_k``, ``photons`` (slots of the map
built in set-up), ``ray_chunk`` and ``check_blocks`` (the 16x16 pixel
blocks the reference renders).

Set-up builds the scene, the photon map (seeded by the run's seed; on a
scene with analytic primitives the pass takes the staged round, and its
time is the user's wait before the first image) and the renderer, and
renders one frame.  Every frame of the window is the same work on the
same inputs.  After the window the first and the last frame are judged
at ``check_blocks`` blocks drawn from the seed against the reference's
own scene, analytic trace, photon map and adaptive frame there
(``ref/adaptive.py``): the image as the render kind judges it
(``img_rel_l1``, ``pix_off``), and ``samps_off``, the share of judged
pixels whose sample count (the samples taken, or the accumulation
state's counter ``samps``) differs from the reference's.  The map's
photons are judged slot by slot (``photon_off``).
"""

from __future__ import annotations

import torch

from . import common, render


class State:
    pass


def _cfg(cls, traffic: dict, seed: int):
    return common.render_config(
        cls, traffic, seed, min_samples=int(traffic["min_spp"]),
        max_samples=int(traffic["max_spp"]),
        noise_thresh=float(traffic["noise_thresh"]), adaptive=True)


def setup(run):
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons)
    tr = run.cell.traffic
    s = State()
    s.scene = common.program_scene(run)
    s.cfg = _cfg(RenderConfig, tr, run.seed)
    batch = trace_photons(s.scene, s.cfg)
    s.pm = build_photon_map(batch, s.scene.world_min.cpu().numpy(),
                            s.scene.world_max.cpu().numpy())
    del batch
    s.renderer = Renderer(s.scene, common.program_camera(run), s.cfg,
                          int(tr["width"]), int(tr["height"]),
                          photon_map=s.pm)
    s.all_active = torch.ones((int(tr["height"]), int(tr["width"])),
                              dtype=torch.bool, device=run.device)
    s.renderer.render()
    s.first = s.last = None
    return s


def _frame(s) -> dict:
    """One frame: its image, the samples each pixel took (the waves in
    which it was active, counted by the render's per-wave hook) and the
    state's counter ``samps``."""
    taken = torch.zeros(s.all_active.shape, dtype=torch.int32,
                        device=s.all_active.device)
    before = s.all_active

    def count(st, wave):
        nonlocal before
        taken.add_(before)
        before = st["active"]

    img, st = s.renderer.render(on_wave=count, return_state=True)
    return {"img": img, "taken": taken, "samps": st["samps"]}


def job(s, i: int) -> int:
    out = _frame(s)
    if s.first is None:
        s.first = out
    s.last = out
    return 1


def after_window(s, run):
    """Count K3's work of a frame in a traced run (one more frame,
    untimed), and free everything but the answers."""
    if run.trace:
        run.work["k3"] = render._k3_frame_work(s)
    return {"first": s.first["img"], "last": s.last["img"],
            "counts": (s.first, s.last), "pm": common.batch_of_map(s.pm)}


def reference(run, ans=None, half=False):
    """The reference's photon batch and its adaptive frame at the drawn
    blocks: {"batch", "map", "pix", "img", "taken", "samps"}.  ``half``:
    the frame with ``min_samples`` halved (the planted fault of pixels
    that stop at half their samples)."""
    from ..ref import analytic
    from ..ref.adaptive import AdaptiveFrame
    from ..ref.config import RenderConfig
    from ..ref.photon import build_photon_map
    tr = run.cell.traffic
    scene = common.ref_scene(run)
    cfg = _cfg(RenderConfig, tr, run.seed)
    batch = analytic.trace_photons(scene, cfg)
    pm = build_photon_map(batch, scene.world_min.cpu().numpy(),
                          scene.world_max.cpu().numpy())
    if half:
        cfg = cfg.replace(min_samples=cfg.min_samples // 2)
    frame = AdaptiveFrame(scene, common.ref_camera(run), cfg,
                          int(tr["width"]), int(tr["height"]),
                          photon_map=pm)
    blocks = render._blocks(run)
    img, taken, samps = frame.render_blocks(blocks)
    return {"batch": (batch.pos, batch.stored), "map": pm,
            "pix": frame.pixels(frame.block_positions(blocks)), "img": img,
            "taken": taken, "samps": samps}


def compare(ans, ref) -> dict:
    """The render kind's numbers, and ``samps_off``: the worse of the first
    and last frame's share of judged pixels whose samples taken or
    counter ``samps`` differ from the reference's."""
    got = render.compare(ans, ref)
    off = []
    for frame in ans["counts"]:
        taken = frame["taken"].reshape(-1)[ref["pix"]]
        samps = frame["samps"].reshape(-1)[ref["pix"]]
        diff = (taken != ref["taken"]) | (samps != ref["samps"])
        off.append(float(diff.float().mean()))
    got["samps_off"] = max(off)
    return got


def _as_answers(run, low) -> dict:
    """The reference's answers at the judged pixels put in the program's
    place (zeros elsewhere)."""
    tr = run.cell.traffic
    n = int(tr["width"]) * int(tr["height"])

    def full(x, shape):
        out = torch.zeros((n,) + shape, dtype=x.dtype, device=run.device)
        out[low["pix"]] = x
        return out

    img = full(low["img"], (3,))
    frame = {"img": img, "taken": full(low["taken"], ()),
             "samps": full(low["samps"], ())}
    return {"first": img, "last": img, "counts": (frame, frame),
            "pm": common.batch_of_map(low["map"])}


def control(run):
    """The reference in bfloat16 put in the program's place, as answers."""
    from ..ref import precision
    with precision.bfloat16():
        return _as_answers(run, reference(run))


def fault(run, name):
    """The reference with a fault planted, put in the program's place:
    ``half``, every pixel stopping at half of ``min_samples``."""
    if name != "half":
        raise ValueError(f"no fault {name!r} for an adaptive frame")
    return _as_answers(run, reference(run, half=True))
