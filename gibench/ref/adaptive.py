"""The reference's adaptive frame at the blocks it is given: the program's
``Renderer`` with ``adaptive=True`` (block compaction on), in plain
torch, over the analytic trace (``analytic.radiance_wave``).

Every stochastic stream is keyed on the lane id, and wave w's lane of
block-ordered position p has id w*N + p whatever else the wave traces, so
a pixel's samples depend on its own lane ids alone, and whether it is
active on its own samples alone.  The reference therefore runs the waves
over the given blocks only, each wave over those of them that still hold
an active pixel, until none does or ``max_samples`` waves ran; their
pixels then equal the whole frame's.

``_accumulate`` is a frozen copy of ``Renderer._accumulate`` of
``gi_raytracer_tpu_torch/render/integrator.py`` at commit
08137f7bb5cc449304fb11a330e0c750f933f967 over a flat list of pixels.
"""

from __future__ import annotations

import torch

from . import analytic
from .integrator import Frame


class AdaptiveFrame(Frame):
    """The adaptive frame of ``width`` x ``height`` pixels."""

    def wave_lanes(self, ro, rd, sx_all, sy_all, lane_ids):
        """One wave of these lanes over the analytic trace: ((R, 3)
        radiance, (R,) closest plus shadow rays of each lane)."""
        rays = torch.zeros(ro.shape[0], dtype=torch.int64, device=ro.device)
        c, _ = analytic.radiance_wave(self.scene, self.cfg, ro, rd, sx_all,
                                      sy_all, self.photon_map, lane_ids,
                                      self.rows, rays)
        return c, rays

    def _accumulate(self, st: dict, c, s: int) -> dict:
        """One adaptive-sampling update (EMA variance, sample counts)."""
        cfg = self.cfg
        mean, var = st["mean"], st["var"]
        samps, active = st["samps"], st["active"]
        new_mean = c if s == 0 else (s * mean + c) / (s + 1.0)
        mean_out = torch.where(active[..., None], new_mean, mean)
        dv = torch.linalg.vector_norm(new_mean - mean, dim=-1)
        var = torch.where((s > 0) & active, (5.0 * var + dv) / 6.0, var)
        extend = (s > 0) & (var > cfg.noise_thresh)
        samps = torch.where(active, samps + 1 - 2 * extend.to(torch.int32),
                            samps)
        active = active & (samps < cfg.min_samples)
        return {"mean": mean_out, "var": var, "samps": samps,
                "active": active}

    @torch.no_grad()
    def render_blocks(self, blocks):
        """The adaptive frame over the blocks ``blocks`` (block-major
        indices), their pixels in ``block_positions`` order: ((P, 3) mean,
        (P,) samples each pixel took, (P,) int32 sample counter ``samps``
        of the accumulation state)."""
        N = self.width * self.height
        pos = self.block_positions(blocks)
        P, dev = pos.shape[0], self.device
        st = {"mean": torch.full((P, 3), 0.5, dtype=self.dtype, device=dev),
              "var": torch.zeros(P, dtype=self.dtype, device=dev),
              "samps": torch.zeros(P, dtype=torch.int32, device=dev),
              "active": torch.ones(P, dtype=torch.bool, device=dev)}
        taken = torch.zeros(P, dtype=torch.int32, device=dev)
        lane = torch.arange(256, device=dev)
        for s in range(self.cfg.max_samples):
            live = torch.nonzero(st["active"].view(-1, 256).any(1)).squeeze(1)
            if not live.numel():
                break
            at = (live[:, None] * 256 + lane[None, :]).reshape(-1)
            ro, rd, sx_all, sy_all = self.wave_inputs(s, pos[at])
            c_at, _ = self.wave_lanes(ro, rd, sx_all, sy_all,
                                      (s * N + pos[at]) & 0xFFFFFFFF)
            c = torch.zeros((P, 3), dtype=self.dtype, device=dev)
            c[at] = c_at.to(c.dtype)
            taken += st["active"].to(torch.int32)
            st = self._accumulate(st, c, s)
        return st["mean"], taken, st["samps"]
