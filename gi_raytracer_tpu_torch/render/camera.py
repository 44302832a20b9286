"""Camera model and primary ray generation (counterpart of
``gi_raytracer_tpu.render.camera``)."""

from __future__ import annotations

import dataclasses

import torch

from .. import telemetry
from .geom import normalize

SENSOR_DIAG = 0.035 * 240 * 2
FOCAL_DIST = 0.04 * 240


@dataclasses.dataclass
class Camera:
    pos: tuple = (10.0, 5.0, 0.0)
    look_at: tuple = (0.0, 0.0, 0.0)
    sensor_diag: float = SENSOR_DIAG
    focal_dist: float = FOCAL_DIST
    focal_blur: float = 0.0

    def basis(self, dtype=torch.float32, device=None):
        """(pos, forward, up, cam_right).  ``pos`` and ``look_at`` may be
        tensors that carry a gradient (``torch.as_tensor`` keeps it)."""
        # a copy of host numbers to the card waits for it: a sync each
        with telemetry.sync("camera.pos"):
            pos = torch.as_tensor(self.pos, dtype=dtype, device=device)
        with telemetry.sync("camera.look_at"):
            at = torch.as_tensor(self.look_at, dtype=dtype, device=device)
        fwd = normalize(at - pos)
        with telemetry.sync("camera.up"):
            up0 = torch.tensor([0.0, 1.0, 0.0], dtype=dtype, device=device)
        right = normalize(torch.linalg.cross(up0, fwd))
        up = torch.linalg.cross(fwd, right)
        cam_right = normalize(torch.linalg.cross(fwd, up))
        return pos, fwd, up, cam_right


def ray_frame(cam: Camera, width: int, height: int, dtype=torch.float32,
              device=None):
    """(pos, up, cam_right, screen center, half-width shw, half-height shh):
    the constants ``primary_rays`` builds its rays from, the same for every
    ray of a frame."""
    pos, fwd, up, cam_right = cam.basis(dtype, device)
    with telemetry.sync("camera.diag"):
        diag2 = torch.tensor(float(width * width + height * height),
                             dtype=dtype, device=device)
    shw = (cam.sensor_diag * width) / torch.sqrt(diag2)
    shh = shw * (height / width)
    center = pos + cam.focal_dist * fwd
    return pos, up, cam_right, center, shw, shh


def primary_rays(cam: Camera, width: int, height: int, dx, dy):
    """Rays through screen positions dx in [0,width), dy in [0,height);
    returns (origins (R,3), directions (R,3))."""
    pos, up, cam_right, center, shw, shh = ray_frame(cam, width, height,
                                                     dx.dtype, dx.device)
    pixel = (center
             + (shw * (dx[:, None] / width - 0.5)) * cam_right[None, :]
             - (shh * (dy[:, None] / height - 0.5)) * up[None, :])
    eye = torch.broadcast_to(pos[None, :], pixel.shape)
    return eye, normalize(pixel - eye)
