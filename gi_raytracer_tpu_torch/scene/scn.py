"""Parser for the reference's ``.scn`` scene language (sceneLoader.cpp).

Counterpart of ``gi_raytracer_tpu.scene.scn``.
Grammar (whitespace-separated tokens, ``#`` comments):

  imTex <file> <utile> <vtile>
  checkerboardTex <ar> <ag> <ab> <br> <bg> <bb> <tiles>
  colorTex <r> <g> <b>
  mat <diffuse_tex> <emissive_tex> <roughness> <opacity> [<IOR>]
  multiMat <i> <j> ...            (parsed but unused, like the reference)
  mesh <file.obj> <px py pz> <rx ry rz> <mat>
  sphere <px py pz> <rad> <mat>
  cone <px py pz> <rx ry rz> <rad> <height> <mat>   (extension)
  box <px py pz> <sx sy sz> <rx ry rz> <mat>
  light <px py pz> <r g b> <rad>
  heightFog <px py pz> <sx sy sz> <r g b> <density> <scatter> <scale>
  photons <count> [<depth>]
  samples <min> <max> <noise_thresh>
  ambient <r> <g> <b>
  camera <px py pz> <lx ly lz>

Returns the compiled Scene (on the card unless ``device="cpu"``) plus the
camera and config overrides.  ``imTex`` decodes a PNG with the port's
own reader (``io.load_png_rgba``) and any other format with Pillow,
imported only there.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..config import RenderConfig
from ..io.image import is_png, load_png_rgba
from .build import SceneBuilder
from .meshgen import box_mesh
from .objio import load_obj


@dataclasses.dataclass
class LoadedScene:
    scene: object               # gi_raytracer_tpu_torch.scene.types.Scene
    config: RenderConfig
    camera_pos: tuple
    camera_look_at: tuple


def _load_image_rgba(path: str) -> tuple[np.ndarray, bool]:
    """Image file -> (H, W, 4) linear-space float RGBA + has_alpha flag
    (de-gamma 2.2 once here, not per fetch).  PNGs are decoded by
    ``io.load_png_rgba`` (``has_alpha`` from the colour type); other
    formats need Pillow."""
    if is_png(path):
        arr, has_alpha = load_png_rgba(path)
    else:
        from PIL import Image

        im = Image.open(path)
        has_alpha = im.mode in ("RGBA", "LA", "PA")
        arr = np.asarray(im.convert("RGBA"), np.float32) / 255.0
    arr[..., :3] = arr[..., :3] ** 2.2
    return arr, has_alpha


def load_scene(path: str, base_config: RenderConfig | None = None,
               device="cuda", dtype=torch.float32) -> LoadedScene:
    cfg = base_config or RenderConfig()
    b = SceneBuilder()
    scene_dir = os.path.dirname(os.path.abspath(path))
    camera_pos = (10.0, 5.0, 0.0)       # main.cpp:28 default
    camera_look_at = (0.0, 0.0, 0.0)
    overrides: dict = {}

    with open(path, "r") as f:
        tokens: list[str] = []
        for line in f:
            tokens.extend(line.split("#", 1)[0].split())

    i = 0

    def take(n):
        nonlocal i
        out = tokens[i:i + n]
        i += n
        return out

    def _is_num(t: str) -> bool:
        try:
            float(t)
            return True
        except ValueError:
            return False

    def take_nums(max_n):
        """Up to max_n numeric tokens: the reference's fscanf formats stop
        at the first non-numeric token (``photons 750000`` with no depth,
        ``mat`` with 4 arguments)."""
        nonlocal i
        out = []
        while len(out) < max_n and i < len(tokens) and _is_num(tokens[i]):
            out.append(float(tokens[i]))
            i += 1
        return out

    while i < len(tokens):
        key = tokens[i]
        i += 1
        if key == "imTex":
            fn, ut, vt = take(3)
            img, has_alpha = _load_image_rgba(os.path.join(scene_dir, fn))
            b.add_texture_image(img, (float(ut), float(vt)), has_alpha)
        elif key == "checkerboardTex":
            v = [float(x) for x in take(7)]
            b.add_texture_checker(int(v[6]), v[0:3], v[3:6])
        elif key == "colorTex":
            b.add_texture_const([float(x) for x in take(3)])
        elif key == "mat":
            v = take_nums(5)
            ior = v[4] if len(v) > 4 else 1.0
            b.add_material(int(v[0]), int(v[1]), v[2], v[3], ior)
        elif key == "multiMat":
            while i < len(tokens) and tokens[i].lstrip("-").isdigit():
                i += 1
        elif key == "mesh":
            v = take(8)
            p = os.path.join(scene_dir, v[0])
            if not os.path.exists(p):
                # the JAX loader skips a missing mesh the same way
                print(f"[scn] missing mesh {v[0]}; skipping")
                continue
            tv, tn, tuv = load_obj(p, tuple(float(x) for x in v[1:4]),
                                   tuple(float(x) for x in v[4:7]))
            b.add_triangles(tv, tn, tuv, int(v[7]))
        elif key == "sphere":
            v = take(5)
            b.add_sphere(tuple(float(x) for x in v[0:3]), float(v[3]),
                         int(v[4]))
        elif key == "cone":
            v = take(9)
            b.add_cone(tuple(float(x) for x in v[0:3]),
                       tuple(float(x) for x in v[3:6]),
                       float(v[6]), float(v[7]), int(v[8]))
        elif key == "box":
            v = take(10)
            tris = box_mesh([float(x) for x in v[0:3]],
                            [float(x) for x in v[3:6]],
                            [float(x) for x in v[6:9]])
            b.add_triangles(tris, None, None, int(v[9]))
        elif key == "light":
            v = [float(x) for x in take(7)]
            b.add_light(v[0:3], v[3:6], v[6])
        elif key == "heightFog":
            v = [float(x) for x in take(12)]
            b.add_height_fog(v[0:3], v[3:6], v[6:9], v[9], v[10], v[11],
                             seed=cfg.seed)
        elif key == "photons":
            v = take_nums(2)
            overrides["photons"] = int(v[0])
            if len(v) > 1:
                overrides["photon_depth"] = int(v[1])
        elif key == "samples":
            v = take(3)
            overrides["min_samples"] = int(v[0])
            overrides["max_samples"] = int(v[1])
            overrides["noise_thresh"] = float(v[2])
        elif key == "ambient":
            overrides["ambient"] = tuple(float(x) for x in take(3))
        elif key == "camera":
            v = [float(x) for x in take(6)]
            camera_pos = tuple(v[0:3])
            camera_look_at = tuple(v[3:6])
        else:
            raise ValueError(f"unknown .scn keyword: {key!r}")

    cfg = cfg.replace(**overrides) if overrides else cfg
    scene = b.build(dtype=dtype, device=device)
    return LoadedScene(scene=scene, config=cfg, camera_pos=camera_pos,
                       camera_look_at=camera_look_at)
