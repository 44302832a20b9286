"""The reference's trace against the program's plain path on the CPU,
where the stated hit order decides: two triangles in parallel planes a
thousandth of the distance apart, one larger than the other, every ray
hitting both inside.  Their keys (t_num x 1/bf16(|det|)) round |det| to
bfloat16 by up to 2^-9 each, so on a share of the rays the farther
triangle has the smaller key, and the program hits it."""

import numpy as np
import torch

from gibench.ref import trace as ref_trace

GAP = 0.01          # between the planes, at a distance of about 10


def _pair(builder_cls):
    b = builder_cls()
    tex = b.add_texture_const((0.5, 0.5, 0.5))
    mat = b.add_material(tex, b.add_texture_const((0.0, 0.0, 0.0)),
                         1.0, 1.0)
    near = [[-6.0, -6.0, 0.0], [7.0, -6.0, 0.0], [-6.0, 7.0, 0.0]]
    far = [[-5.0, -5.0, GAP], [9.3, -5.0, GAP], [-5.0, 9.3, GAP]]
    b.add_triangles(np.array([near, far]), mat_id=mat)
    b.add_light((0.0, 0.0, -5.0), (1.0, 1.0, 1.0), 0.1)
    return b.build(device="cpu")


def _rays(n=2000):
    g = torch.Generator().manual_seed(5)
    xy = torch.rand((n, 2), generator=g) * 3.0 - 1.5
    ro = torch.tensor([[0.0, 0.0, -10.0]]).expand(n, 3).contiguous()
    rd = torch.cat([xy, torch.full((n, 1), 10.0)], 1)
    return ro, rd / rd.norm(dim=-1, keepdim=True)


def test_near_ties_follow_the_stated_hit_order():
    from gi_raytracer_tpu_torch.ops import intersect
    from gi_raytracer_tpu_torch.scene import SceneBuilder
    from gibench.ref.build import SceneBuilder as RefBuilder
    prog, ref = _pair(SceneBuilder), _pair(RefBuilder)
    ro, rd = _rays()
    mine = intersect.trace_closest(prog, ro, rd)
    theirs = ref_trace.trace_closest(ref, ro, rd)
    assert bool((theirs.prim >= 0).all())
    # the program numbers the two its own way: compare the planes hit
    far_mine = mine.t > 10.0 * (1 + GAP / 20) / rd[:, 2]
    far_ref = theirs.t > 10.0 * (1 + GAP / 20) / rd[:, 2]
    assert 0.05 < float(far_ref.float().mean()) < 0.95
    assert bool((far_mine == far_ref).all())
