"""The port's PNG reader against Pillow, image textures loaded without
Pillow, and a render resumed from a state without a ray counter.

``io.load_png`` must read what Pillow writes (every row filter, every
8-bit colour type) as ``Image.open(p).convert("RGB")`` does, and
``io.load_png_rgba`` as ``convert("RGBA")`` does: both exactly (the same
bytes over 255).  ``.scn`` ``imTex`` PNGs then load to the JAX loader's
atlas with no Pillow on the card host.  ``Renderer.render`` accepts a
resumed state that has no ``rays``, as the JAX renderer does."""

import glob
import os
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from gi_raytracer_tpu.config import RenderConfig as JaxConfig
from gi_raytracer_tpu.scene.scn import load_scene as jax_load_scene
from gi_raytracer_tpu_torch import io as tio
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.scene.scn import load_scene

from _torch_parity import assert_scene_arrays_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = sorted(glob.glob(os.path.join(REPO, "docs", "validation",
                                          "*.png")))


def _pillow(path, mode):
    return np.asarray(Image.open(path).convert(mode), np.float32) / 255.0


def test_there_are_committed_pngs():
    assert len(COMMITTED) == 8


@pytest.mark.parametrize("path", COMMITTED,
                         ids=[os.path.basename(p) for p in COMMITTED])
def test_load_png_reads_committed_pngs_like_pillow(path):
    """Pillow wrote these with adaptive row filters."""
    np.testing.assert_array_equal(tio.load_png(path), _pillow(path, "RGB"))


def _test_image(rng, H=37, W=53):
    """RGBA bytes with a smooth ramp (so the encoder picks Sub, Up, Average
    and Paeth rows) beside noise."""
    img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    img[:, :20] = np.linspace(0, 255, 20)[None, :, None].astype(np.uint8)
    img[H // 2:, 20:30] = np.arange(10, dtype=np.uint8)[None, :, None] * 7
    return img


def _written(tmp_path, mode, **save):
    """A PNG that Pillow writes in ``mode`` (a palette image is quantized
    to ``colors`` entries, 4 bits for 16 or fewer)."""
    img = _test_image(np.random.default_rng(3))
    colors = save.pop("colors", None)
    if mode == "P":
        im = Image.fromarray(img[..., :3]).quantize(colors=colors)
    elif mode == "L":
        im = Image.fromarray(img[..., 0], "L")
    elif mode == "LA":
        im = Image.fromarray(img[..., [0, 3]], "LA")
    else:
        im = Image.fromarray(img[..., :len(mode)], mode)
    path = str(tmp_path / f"{mode}{colors or ''}.png")
    im.save(path, **save)
    return path


KINDS = [("L", {}), ("LA", {}), ("RGB", {}), ("RGBA", {}),
         ("RGB", {"optimize": True}), ("P", {"colors": 200}),
         ("P", {"colors": 16}), ("P", {"colors": 2}),
         ("P", {"colors": 12, "transparency": bytes(range(0, 240, 20))}),
         ("RGB", {"transparency": (0, 0, 0)}), ("L", {"transparency": 7})]


@pytest.mark.parametrize("mode,save", KINDS,
                         ids=[f"{m}-{'-'.join(s)}" for m, s in KINDS])
def test_load_png_reads_each_colour_type_like_pillow(tmp_path, mode, save):
    path = _written(tmp_path, mode, **dict(save))
    np.testing.assert_array_equal(tio.load_png(path), _pillow(path, "RGB"))
    rgba, has_alpha = tio.load_png_rgba(path)
    np.testing.assert_array_equal(rgba, _pillow(path, "RGBA"))
    assert has_alpha == (Image.open(path).mode in ("LA", "RGBA"))


def test_load_png_reads_save_png(tmp_path):
    img = np.random.default_rng(4).uniform(size=(9, 11, 3))
    path = str(tmp_path / "s.png")
    tio.save_png(path, img)
    np.testing.assert_array_equal(tio.load_png(path), _pillow(path, "RGB"))


def test_load_png_refuses_what_it_cannot_read(tmp_path):
    """16-bit samples and interlaced images raise (nothing in the repo
    writes them)."""
    path = str(tmp_path / "g16.png")
    Image.fromarray(np.arange(12, dtype=np.uint16).reshape(3, 4) * 5000,
                    "I;16").save(path)
    with pytest.raises(ValueError, match="bit depth 16"):
        tio.load_png(path)
    path = str(tmp_path / "i.png")
    tio.save_png(path, np.zeros((4, 4, 3)))
    data = bytearray(open(path, "rb").read())
    data[28] = 1                          # IHDR interlace method: Adam7
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="interlace 1"):
        tio.load_png(path)
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tio.load_png(str(tmp_path / "n.png"))


@pytest.mark.parametrize("mode", ["RGBA", "P", "LA"])
def test_imtex_png_loads_like_jax_without_pillow(tmp_path, monkeypatch,
                                                 mode):
    """Both packages' load_scene build the same texture atlas and alpha
    flags from a PNG imTex; the port's loader never imports Pillow."""
    save = {"colors": 40} if mode == "P" else {}
    path = _written(tmp_path, mode, **save)
    os.replace(path, tmp_path / "tex.png")
    (tmp_path / "s.scn").write_text(
        "imTex tex.png 2 3\ncolorTex 1 1 1\nmat 0 1 1 1\n"
        "box 0 0 0 1 1 1 0 0 0 0\nlight 0 3 0 1 1 1 0.2\n")
    scn = str(tmp_path / "s.scn")
    want = jax_load_scene(scn, JaxConfig(), dtype=np.float32)
    import builtins
    real_import = builtins.__import__

    def no_pillow(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow on the card host")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pillow)
    got = load_scene(scn, RenderConfig(), device="cpu")
    monkeypatch.undo()
    assert_scene_arrays_equal(got.scene, want.scene, atol=0)
    assert bool(got.scene.textures.has_alpha[0]) == (mode != "P")


def test_render_resumes_from_a_state_without_rays():
    """A state saved before the ray counter existed resumes (the counter
    starts at 0, as in the JAX renderer) to the uninterrupted image."""
    from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
    from gi_raytracer_tpu_torch.scene.cornell import (CAMERA_LOOK_AT,
                                                      CAMERA_POS,
                                                      cornell_box)
    scene = cornell_box(SceneBuilder, meshgen, False).build(device="cpu")
    cfg = RenderConfig(adaptive=False, min_samples=2, max_samples=2,
                       max_depth=2)
    r = Renderer(scene, Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT), cfg,
                 16, 16)
    saved = {}

    def keep(st, s):
        if s == 0:
            saved.update({k: v.clone() if torch.is_tensor(v) else v
                          for k, v in st.items()})

    full, st_full = r.render(on_wave=keep, return_state=True)
    wave0_rays = saved.pop("rays")
    img, st = r.render(state=saved, return_state=True)
    assert torch.equal(img, full)
    assert int(st["wave"]) == 2
    assert float(st["rays"]) == float(st_full["rays"] - wave0_rays) > 0
