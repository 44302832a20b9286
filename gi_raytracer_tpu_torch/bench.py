"""The port's benchmark: the five metrics of the root ``bench.py``, on the
card.

    python -m gi_raytracer_tpu_torch.bench [--repeats 3]

The workload is ``bench.py``'s on the in-code Cornell box
(``scene.cornell.cornell_box(full=True)``, 2,198 triangles; ``bench.py``
reads the reference's ``test.scn``, which the repo does not hold): 512x512,
fixed 8 spp, depth 8, kNN k = 32, 750,000 photon slots.  One JSON line a
metric, in ``bench.py``'s order, the headline last:

* ``photons_emitted_per_s``: photon slots over the seconds of
  ``trace_photons``;
* ``knn_gather_mphotons_per_s``: k photons per query over the seconds of
  the caustic estimate (K3) at the first-hit points (K2) of one wave of
  the frame's primary rays, as ``bench.py:98-120``;
* ``train_step_seconds``: ``train.TrainStep``, ``bench.py``'s first rung
  (256x256, 1 spp, depth 8, a 50,000-slot map);
* ``rays_per_s_cornell_512_8spp_nophotons``: the honest ray count over the
  seconds of ``Renderer.render()`` without the map;
* ``rays_per_s_cornell_512_8spp``: the same with the map, with
  ``vs_baseline`` over ``BASELINE.json``'s 32-core projection of the
  reference (measured on ``test.scn``, not this box: the line says so).

Every metric runs once as a warm-up, then ``--repeats`` times; the line
gives the median (host clock, ended by a device synchronise) and every
repeat.  Each metric runs in its own ``try``: a metric that fails prints
``{"metric": name, "error": ...}``, the others still run, and the script
exits 1.  The card is the default and there is no fallback: ``--device
cpu`` (with the size flags) runs the plain versions, for tests.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback

import torch

METRICS = ("photons_emitted_per_s", "knn_gather_mphotons_per_s",
           "train_step_seconds", "rays_per_s_cornell_512_8spp_nophotons",
           "rays_per_s_cornell_512_8spp")

BASELINE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BASELINE.json")
BASELINE_SCENE = ("the reference's time is of scenes/cornell/test.scn; "
                  "this run renders the in-code box of scene/cornell.py "
                  "(cornell_box(full={}))")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(run, device, repeats):
    """(last result, median seconds, every repeat's seconds) of ``run()``
    after one warm-up call."""
    run()
    secs = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        secs.append(time.perf_counter() - t0)
    return out, statistics.median(secs), secs


class Bench:
    """The workload, built once; each metric method returns its line's
    fields and keeps what later metrics reuse (the batch, the map)."""

    def __init__(self, args):
        from .config import RenderConfig
        from .ops._cuda import resolve_device
        from .render import Camera
        from .scene import SceneBuilder, meshgen
        from .scene.cornell import CAMERA_LOOK_AT, CAMERA_POS, cornell_box

        self.args = args
        self.device = resolve_device(args.device)
        self.backend = f"torch-{self.device.type}"
        self.cfg = RenderConfig(min_samples=args.spp, max_samples=args.spp,
                                adaptive=False, max_depth=args.depth,
                                photons=args.photons, knn_k=32, seed=0)
        self.cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
        self.scene = cornell_box(SceneBuilder, meshgen,
                                 full=args.scene == "full").build(
            device=self.device)
        self.batch = self.pm = None

    def _map(self):
        from .render.photon import build_photon_map
        if self.pm is None:
            self.pm = build_photon_map(
                self._batch(), self.scene.world_min.cpu().numpy(),
                self.scene.world_max.cpu().numpy())
        return self.pm

    def _batch(self):
        from .render.photon import trace_photons
        if self.batch is None:
            self.batch = trace_photons(self.scene, self.cfg)
        return self.batch

    def photons_emitted_per_s(self):
        from .render.photon import trace_photons
        batch, secs, all_secs = _timed(
            lambda: trace_photons(self.scene, self.cfg), self.device,
            self.args.repeats)
        self.batch = batch
        return {"value": self.cfg.photons / secs, "unit": "photons/s",
                "stored": int(batch.stored.sum()), "seconds": secs,
                "repeats": all_secs}

    def knn_gather_mphotons_per_s(self):
        from .ops.intersect import trace_closest
        from .render import Renderer
        from .render.photon import sample_photons_backend
        W = H = self.args.size
        pm = self._map()
        ro, rd, _, _ = Renderer(self.scene, self.cam, self.cfg, W,
                                H).wave_inputs(0)
        hit = trace_closest(self.scene, ro, rd)
        pts = ro + torch.where(hit.prim >= 0, hit.t, 0.0)[:, None] * rd
        dirs = -rd
        k = self.cfg.knn_k
        _, secs, all_secs = _timed(
            lambda: sample_photons_backend(pm, pts, dirs, k,
                                           self.cfg.knn_backend), self.device,
            self.args.repeats)
        R = pts.shape[0]
        return {"value": R * k / secs / 1e6, "unit": "Mphotons/s",
                "points": R, "k": k, "seconds": secs, "repeats": all_secs,
                "query_protocol": "primary-hit"}

    def train_step_seconds(self):
        from .train import TrainStep
        a = self.args
        step = TrainStep(self.scene, self.cam, self.cfg, self._batch(),
                         size=a.train_size, depth=a.depth,
                         photons=a.train_photons)
        (loss, g_pcol, g_lcol), secs, all_secs = _timed(
            step, self.device, a.repeats)
        return {"value": secs, "unit": "s",
                "workload": f"cornell {a.train_size}x{a.train_size} 1spp "
                            f"wavefront, depth {a.depth}, staged fwd+bwd, "
                            f"{a.train_photons / 1000:g}k-photon map; grads: "
                            "photon colors + light color",
                "loss": float(loss),
                "grad_norms": [float(g_pcol.norm()), float(g_lcol.norm())],
                "repeats": all_secs}

    def _render_rate(self, photon_map):
        from .render import Renderer
        r = Renderer(self.scene, self.cam, self.cfg, self.args.size,
                     self.args.size, photon_map=photon_map)
        (_, st), secs, all_secs = _timed(
            lambda: r.render(return_state=True), self.device,
            self.args.repeats)
        rays = float(st["rays"])
        return {"value": rays / secs, "unit": "rays/s", "seconds": secs,
                "rays_traced": rays, "repeats": all_secs}

    def rays_per_s_cornell_512_8spp_nophotons(self):
        return self._render_rate(None)

    def rays_per_s_cornell_512_8spp(self):
        line = self._render_rate(self._map())
        try:
            with open(BASELINE) as f:
                ref = json.load(f)["measured_reference"]
        except FileNotFoundError:
            ref = None
        if ref is None:
            line.update(vs_baseline=None, baseline="BASELINE.json not found")
        else:
            r32 = ref["rays_per_s_32core_projected"]
            r2 = ref["rays_per_s_measured_2core"]
            line.update(vs_baseline=line["value"] / r32,
                        vs_ref_host=line["value"] / r2,
                        baseline=f"measured 32-core projection {r32:.3g} "
                                 "rays/s (BASELINE.json measured_reference)")
        line.update(baseline_scene=BASELINE_SCENE.format(
            self.args.scene == "full"), with_photon_map=True)
        return line


def parse(argv):
    p = argparse.ArgumentParser(prog="gi_raytracer_tpu_torch.bench")
    p.add_argument("--repeats", type=int, default=3,
                   help="timed runs a metric after its warm-up (median)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu for tests)")
    p.add_argument("--size", type=int, default=512, help="frame side")
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=8)
    p.add_argument("--photons", type=int, default=750_000)
    p.add_argument("--train-size", type=int, default=256)
    p.add_argument("--train-photons", type=int, default=50_000)
    p.add_argument("--scene", choices=("full", "small"), default="full",
                   help="the full Cornell box or its 182-triangle variant")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = Bench(args)
    failed = False
    for name in METRICS:
        try:
            line = {"metric": name, **getattr(bench, name)(),
                    "backend": bench.backend}
        except Exception as e:  # reported; the other metrics still run
            failed = True
            traceback.print_exc()
            line = {"metric": name, "error": f"{type(e).__name__}: {e}"[:300],
                    "backend": bench.backend}
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
