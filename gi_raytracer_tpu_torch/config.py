"""Renderer configuration — the same fields and defaults as the JAX
package's ``RenderConfig``, so a config carries across with
``dataclasses.asdict``.  Some fields only steer the JAX package's TPU
backends; the port accepts them and ignores what it has no use for."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # geometry / numerics
    epsilon: float = 1e-5
    shadow_bias: float = 1e-4

    # path tracing depths
    min_depth: int = 2               # bounces before Russian roulette
    max_depth: int = 16

    # adaptive QMC sampling
    min_samples: int = 8
    max_samples: int = 32
    noise_thresh: float = 0.0015
    adaptive: bool = True
    wave_size: int = 1               # TPU dispatch knob; the port traces one
                                     # full-frame wave per loop step

    # photon mapping
    photons: int = 75_000
    photon_depth: int = 5
    photon_retries: int = 64
    knn_k: int = 32
    caustic_max_depth: int = 10

    # the fog march (render/atmosphere.py); fog_lane_chunk is not read
    raymarch_stepsize: float = 0.04
    raymarch_max_steps: int = 512
    fog_lane_chunk: int = 32768

    # camera & output
    focal_blur: float = 0.0
    gamma: float = 2.2
    ambient: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # execution
    dtype: str = "float32"
    intersect_backend: str = "auto"
    knn_backend: str = "auto"
    integrator: str = "auto"         # "auto"|"staged"|"mega"
    compact_wavefront: bool = False
    ray_chunk: int = 1 << 17         # photon emission slots per chunk
    seed: int = 0

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()
