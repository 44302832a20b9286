"""The fog frame: one ``Renderer.render()`` of the program to the finished
image of a scene in height fog, at the traffic's fixed spp, frame after
frame from one caller.

Traffic keys: ``width``, ``height``, ``spp``, ``depth`` and
``check_blocks`` (the 16x16 pixel blocks the reference renders); no
photon map.  The configuration states the render's ``ambient`` term (the
upstream's ``ambient`` directive).

Set-up builds the scene and the renderer and renders one frame; every
frame of the window is the same work on the same inputs.  After the
window the first and the last frame are judged at ``check_blocks``
blocks drawn from the seed against the reference's own scene and fog
frame there (``ref/fog.py``: the step-by-step march), as the render kind
judges them (``img_rel_l1``, ``pix_off``).  Control: the reference in
bfloat16; fault ``shadow_clear``: the reference with the shadow rays'
march skipped.
"""

from __future__ import annotations

import torch

from . import common, render

# the frame's counters and the first and last frame, as the render kind
# keeps them
job = render.job
after_window = render.after_window
compare = render.compare


def _cfg(cls, run):
    """The traffic's ``RenderConfig`` with the configuration's ambient."""
    amb = tuple(float(x) for x in run.cell.config["ambient"])
    return common.render_config(cls, run.cell.traffic, run.seed,
                                ambient=amb)


def setup(run):
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.render import Renderer
    tr = run.cell.traffic
    if int(tr.get("photons", 0)):
        raise ValueError("the fog kind renders without a photon map")
    s = render.State()
    s.scene = common.program_scene(run)
    if not s.scene.has_fog:
        raise ValueError("the fog kind needs a scene with fog")
    s.cfg = _cfg(RenderConfig, run)
    s.pm = None
    s.renderer = Renderer(s.scene, common.program_camera(run), s.cfg,
                          int(tr["width"]), int(tr["height"]))
    s.renderer.render()
    s.first = s.last = s.rays = None
    return s


def reference(run, ans=None, shadow_fog=True):
    """The reference's fog frame at the drawn blocks: {"batch" (None),
    "pix", "img"}.  ``shadow_fog=False``: the fault ``shadow_clear``."""
    from ..ref.config import RenderConfig
    from ..ref.fog import FogFrame
    tr = run.cell.traffic
    frame = FogFrame(common.ref_scene(run), common.ref_camera(run),
                     _cfg(RenderConfig, run), int(tr["width"]),
                     int(tr["height"]), shadow_fog=shadow_fog)
    blocks = render._blocks(run)
    img, rays = frame.render_blocks(blocks)
    run.work["ref_rays_per_frame"] = (float(rays.sum()) * frame.n_blocks
                                      / blocks.numel())
    return {"batch": None, "pix": frame.pixels(frame.block_positions(blocks)),
            "img": img}


def _as_answers(run, low) -> dict:
    """The reference's frame at the judged pixels put in the program's
    place (zeros elsewhere)."""
    tr = run.cell.traffic
    img = torch.zeros((int(tr["width"]) * int(tr["height"]), 3),
                      dtype=low["img"].dtype, device=run.device)
    img[low["pix"]] = low["img"]
    return {"first": img, "last": img}


def control(run):
    """The reference in bfloat16 put in the program's place, as answers."""
    from ..ref import precision
    with precision.bfloat16():
        return _as_answers(run, reference(run))


def fault(run, name):
    """The reference with a fault planted, put in the program's place:
    ``shadow_clear``, shadow rays that march no fog."""
    if name != "shadow_clear":
        raise ValueError(f"no fault {name!r} for a fog frame")
    return _as_answers(run, reference(run, shadow_fog=False))
