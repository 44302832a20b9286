"""Port parity of adaptive rendering: the JAX Renderer's fused adaptive
render (its ``_block_adaptive_wave``: only the 16x16 blocks still active
are traced, in groups of G blocks) against the port's ``Renderer.render``
(the same blocks as one wave, ``Renderer.block_wave``) on the small
Cornell box in float64.

Gates: ``mean`` within 1e-6; ``samps``, ``active``, ``wave`` and ``rays``
equal.  At 32x32 (4 blocks) and 48x48 (9 blocks) the JAX group is one
block.  At 80x80 (25 blocks) it is 3 blocks: a group past the active
count is filled with inactive blocks, and the last group's start is
clamped back over blocks an earlier group traced (the case the JAX
renderer's skipped-group guard exists for).  The JAX counter counts those
lanes too; the port traces each active block once (ROADMAP C.8).  There
the JAX count is held to the port's recount of the JAX groups' blocks,
exactly, and the image and the masks to the port's as above."""

import dataclasses

import numpy as np
import pytest
import torch

import gi_raytracer_tpu.scene.build as jb
from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.render import Camera as JaxCamera
from gi_raytracer_tpu.render.integrator import Renderer as JaxRenderer
from gi_raytracer_tpu.scene import meshgen as jmeshgen
from gi_raytracer_tpu_torch import convert
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.scene.cornell import (cornell_box, CAMERA_POS,
                                                  CAMERA_LOOK_AT)

from _torch_parity import to_numpy


@pytest.fixture(scope="module")
def scenes():
    js = cornell_box(jb.SceneBuilder, jmeshgen, False).build(
        dtype=np.float64)
    ts = convert.scene_from_arrays(
        convert.scene_to_arrays(to_numpy(js)), all_opaque=js.all_opaque,
        device="cpu", dtype=torch.float64)
    return js, ts


def _jax_group_blocks(blocks, n_blocks):
    """The blocks the JAX renderer's groups trace for these active blocks:
    groups of G from the active-first order, each group's start clamped to
    n_blocks - G, as many groups as the active blocks need."""
    G = max(min(128, n_blocks // 8), 1)
    act = np.zeros(n_blocks, bool)
    act[blocks] = True
    order = np.argsort(~act, kind="stable")
    out = [order[min(g * G, n_blocks - G):min(g * G, n_blocks - G) + G]
           for g in range(-(-int(act.sum()) // G))]
    return np.concatenate(out)


@pytest.mark.parametrize("size", [32, 48, 80],
                         ids=["32px-4blocks", "48px-9blocks",
                              "80px-25blocks-partial-group"])
def test_adaptive_render_matches_jax(scenes, size):
    js, ts = scenes
    jcfg = JaxConfig(min_samples=2, max_samples=6, noise_thresh=0.15,
                     max_depth=3, dtype="float64", intersect_backend="pallas")
    cfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    # the main camera: the dark border around the box converges early.
    # The JAX side traces with its Pallas kernel (interpret mode), which
    # selects hits in float32 as the port's trace does; its float64 BVH
    # walk picks another triangle at an edge on a few lanes (ROADMAP C.7)
    jr = JaxRenderer(js, JaxCamera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT),
                     jcfg, size, size)
    want, wst = jr.render(return_state=True)
    r = Renderer(ts, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 size, size)
    assert r.block_adaptive
    masks = [torch.ones((size, size), dtype=torch.bool)]
    got, st = r.render(return_state=True, on_wave=lambda s, w: masks.append(
        s["active"].clone()))

    n_blocks = (size // 16) ** 2
    # some blocks went on past the minimum, and some stopped
    assert r.wave_blocks[0] == n_blocks > r.wave_blocks[-1] > 0
    assert all(a >= b for a, b in zip(r.wave_blocks, r.wave_blocks[1:]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert np.array_equal(st["samps"].numpy(), np.asarray(wst["samps"]))
    assert np.array_equal(st["active"].numpy(), np.asarray(wst["active"]))
    assert st["wave"] == int(wst["wave"]) == len(r.wave_blocks)

    recount = sum(float(r.block_wave(w, torch.from_numpy(_jax_group_blocks(
        r.active_blocks(m).numpy(), n_blocks)))[1])
        for w, m in enumerate(masks[:-1]))
    assert float(wst["rays"]) == recount
    if size < 80:                     # one block a group: the same blocks
        assert float(st["rays"]) == float(wst["rays"])
    else:
        assert float(st["rays"]) < float(wst["rays"])

    # the full frame traced every wave counts more rays, same image
    full, fst = Renderer(ts, r.camera, cfg, size, size,
                         block_compaction=False).render(return_state=True)
    assert float(fst["rays"]) > float(st["rays"])
    assert torch.equal(full, got) and torch.equal(fst["samps"], st["samps"])
