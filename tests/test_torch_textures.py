"""Port parity of the image-texture fetch: ``sample_texture`` (the texture
table) and the packed descriptor path of ``shade_from_rows``
(``_tex_eval_desc``) against the JAX package's ``sample_texture`` and
``_tex_eval_desc`` on one atlas of constant, checker and tiled image
textures, two of them carrying alpha, one at an offset past 2^24 texels,
where a single float32 column would round the offset.  Texel values
follow two prime periods, so a fetch off by one texel shows.  Gate:
equal values (the fetch is an exact gather)."""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gi_raytracer_tpu.render import shading as jsh
from gi_raytracer_tpu.scene import types as JT
from gi_raytracer_tpu_torch.ops import prim_rows
from gi_raytracer_tpu_torch.render import shading as tsh
from gi_raytracer_tpu_torch.scene import types as TT

BIG = (1 << 24) + 3           # the far image's first texel


def _atlas(n):
    i = np.arange(n, dtype=np.int32)
    out = np.empty((n, 4), np.float32)
    out[:, 0] = (i % 4099) / np.float32(4099)
    out[:, 1] = (i % 4093) / np.float32(4093)
    out[:, 2] = (i % 7) / np.float32(7)
    out[:, 3] = (i % 5) / np.float32(5)
    return out


@pytest.fixture(scope="module")
def tables():
    #          kind       offset  w   h   alpha  tiles
    rows = [(JT.TEX_CONST, 0, 1, 1, False, (1.0, 1.0)),
            (JT.TEX_CHECKER, 0, 1, 1, False, (4.0, 4.0)),
            (JT.TEX_IMAGE, 11, 37, 23, True, (3.0, 2.0)),
            (JT.TEX_IMAGE, BIG, 64, 48, False, (1.5, 2.5)),
            (JT.TEX_IMAGE, BIG + 64 * 48, 17, 29, True, (1.0, 1.0))]
    assert int(np.float32(BIG)) != BIG         # one f32 column would round
    K = len(rows)
    rng = np.random.default_rng(0)
    cols = dict(kind=np.array([r[0] for r in rows], np.int32),
                offset=np.array([r[1] for r in rows], np.int32),
                width=np.array([r[2] for r in rows], np.int32),
                height=np.array([r[3] for r in rows], np.int32),
                has_alpha=np.array([r[4] for r in rows]),
                tiles=np.array([r[5] for r in rows], np.float32),
                color=rng.uniform(size=(K, 3)).astype(np.float32),
                color2=rng.uniform(size=(K, 3)).astype(np.float32),
                atlas=_atlas(BIG + 64 * 48 + 17 * 29 + 5))
    jt = JT.Textures(**{k: jnp.asarray(v) for k, v in cols.items()})
    tt = TT.Textures(**{k: torch.from_numpy(v) for k, v in cols.items()})
    R = 6000
    tid = rng.integers(0, K, R).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (R, 2)).astype(np.float32)
    return jt, tt, tid, uv


def test_sample_texture_matches_jax(tables):
    jt, tt, tid, uv = tables
    w_rgb, w_a = jsh.sample_texture(jt, jnp.asarray(tid), jnp.asarray(uv))
    g_rgb, g_a = tsh.sample_texture(tt, torch.from_numpy(tid),
                                    torch.from_numpy(uv))
    assert np.array_equal(g_rgb.numpy(), np.asarray(w_rgb))
    assert np.array_equal(g_a.numpy(), np.asarray(w_a))
    far = tid == 3
    assert far.sum() > 1000
    assert (np.asarray(w_a)[tid == 2] < 1).any()         # alpha carried


def test_packed_descriptor_fetch_matches_jax(tables):
    """The 14-column descriptor path (offset as hi * 4096 + lo)."""
    jt, tt, tid, uv = tables
    jscene = types.SimpleNamespace(textures=jt, has_image_tex=True)
    tscene = types.SimpleNamespace(textures=tt, has_image_tex=True)
    jd = jsh._tex_descriptor(jt, jnp.asarray(tid), jnp.float32)
    td = prim_rows._tex_descriptor(tt, torch.from_numpy(tid), torch.float32)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    w_rgb, w_a = jsh._tex_eval_desc(jscene, jd, jnp.asarray(uv[:, 0]),
                                    jnp.asarray(uv[:, 1]))
    g_rgb, g_a = tsh._tex_eval_desc(tscene, td, torch.from_numpy(uv[:, 0]),
                                    torch.from_numpy(uv[:, 1]))
    assert np.array_equal(g_rgb.numpy(), np.asarray(w_rgb))
    assert np.array_equal(g_a.numpy(), np.asarray(w_a))
    # and it agrees with the table's fetch, past 2^24 too
    t_rgb, _ = tsh.sample_texture(tt, torch.from_numpy(tid),
                                  torch.from_numpy(uv))
    assert torch.equal(g_rgb, t_rgb)
