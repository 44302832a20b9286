"""Smoke run of the PyTorch + CUDA port (gi_raytracer_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --cornell TREE
    python3 chip_smoke.py --glass TREE

Builds the port's CUDA kernels from ``gi_raytracer_tpu_torch/csrc`` with
nvcc (one process per source, into the git-ignored ``build/``) and drives
three paths, each with the launch counts set to 0 just before it and read
just after; each kernel is held against its plain PyTorch version on the
card at the paths' shapes:

* the Cornell main path, first, before any comparison: the full Cornell
  box (2,198 triangles), a 750,000-slot photon pass, the photon map, and
  512x512 renders at a fixed 8 samples per pixel, depth 8, kNN k = 32,
  with the map and without it, CORNELL_RENDERS of each in turns (K1
  bounce megakernel, the photon pass's round kernel, K3 kNN);
* phase A, big scene: the terrain of ``scripts/bench_big_scenes.py`` at
  its three sizes (250,632, 500,000 and 999,698 triangles), each rendered
  at 256x256, 2 spp, depth 3, no photons (the staged wave on K4, the
  superchunk trace), with K4 timed on one wave's primary rays and, at 1M
  triangles, on the diffuse bounce and shadow rays from their hits;
* phase B, high-poly glass: the Cornell box with a 131,072-triangle glass
  sphere (131,222 triangles), a 250,000-slot photon pass, the map, and a
  256x256, 4 spp, depth 8 render with it (K4 closest and any hit, K3);
* phase C, analytic Cornell: the box with analytic glass and mirror
  spheres, an analytic cone and an image-textured floor (22 triangles), a
  750,000-slot photon pass (K2 and the sphere and cone passes), the map,
  and a 512x512 adaptive render (8 to 32 spp, noise 0.0015, depth 8, k 32)
  whose waves trace only the 16x16 blocks still active (the staged wave on
  K2, K3); the same render on full-frame waves must give the same image
  and samples with more rays;
* phase D, fog Cornell: scripts/validate_golden.py's cornell_fog (the
  mesh box, heightFog 4 3.4 0 16 8 8.4 1 1 1 .05 .5 2, ambient 0.35),
  512x512, 4 spp, depth 6, no photons (the staged wave on K2 with the fog
  march kernel), which must differ visibly from the fog-free render; the
  fog march kernel held bit for bit to the blocked torch march and the
  step loop on wave 0's primary rays, timed beside them; one profiled
  render gives the march's share of the device time;
* the CLI: ``cli.main(["render", ...])`` on a scene with spheres, a cone
  and fog, 128x128 with 20,000 photon slots and a checkpoint, then again
  stopped after its first wave and resumed from that checkpoint: the PNG
  must read back at 128x128x3 and the resumed image equal the first; then
  once more with ``--profile``, whose PNG must equal the first bit for
  bit and whose torch.profiler trace must parse and hold one
  ``gi_walk_kernel`` (K2) event, and one ``gi_knn_kernel`` and one
  ``gi_knn_focal_kernel`` (K3's two tiers) event, for each launch the
  counters saw inside the profiled region;
* the gradient path (``grad_phase``): bench.py's train step, the mesh
  Cornell box at 256x256, 1 spp, depth 8 on the staged wave (K2 and K3
  forward, the kNN backward the plain estimator's VJP) with a map of the
  first 50,000 slots of the main path's photon batch, gradients of
  mean((c - 0.25)^2) to the photon colours and the light colour, timed
  (median of 3 after one warm-up) and profiled; the same step with the
  plain forward, whose loss and gradients must agree; gradcheck's seven
  families in float64 on the card, each under the JAX test's tolerance;
  and ``cli grad-check`` on a box with a committed PNG as image texture;
* the bench: ``python -m gi_raytracer_tpu_torch.bench --repeats 1`` in a
  subprocess, which must exit 0 with its five metric lines (the root
  bench.py's names and order, headline last), finite, from the card;
* the distribution phase: two ranks spawned by ``parallel.mesh.run_ranks``
  share the card over gloo and run the main path split between them: the
  750,000-slot photon pass by slots (``trace_photons_sharded``), the
  512x512 render by rows (``render_fused_sharded``) and the train step by
  rays (``train_step_sharded``), with K1, K2 and K3 launches counted in
  each rank; against the single process (photon pass with ``ray_chunk``
  375,000): stored mask equal, positions and colours within rtol 1e-6,
  image max error under 1e-5 with the ray count equal, loss and updated
  parameters within rel 1e-5.

The wave-inputs kernel (``csrc/wave_inputs.cu``) is held bit for bit to
its plain version (``Renderer.wave_inputs_plain``) on wave 0 at 512x512,
depth 8 and at 256x256, depth 3, and its device ms a call logged beside
the bound of its output bytes and the plain version's ms.

K1 is also held, on adaptive renders of the mesh Cornell box (8 to 32 spp,
with and without the map), to the same render with block compaction off:
its waves then carry the lane ids of the blocks still active, with gaps.

K2 and K4 (the two launches of ``csrc/walk.cuh``) are also timed on the
traces of one staged round of their photon passes, the Cornell box's
round kernel (the walk under its photon-round policy) on round 0 of one
chunk (CUDA events), and every time of K2, K4 and
K1 comes with the ray-triangle tests the walks made and the bound from
them.  K1 is held against its plain version on one 512x512 wave (about
four lanes a resident thread, so its lane queue refills) of the Cornell
box (its feature table walked from shared memory) and of an
8,342-triangle glass box (a table past a block's shared memory, walked
from device memory), each with and without a photon map; K1's and K3's
resources on the card are printed.  K3 is held against its plain version,
the whole-window estimate, on the Cornell map (whose densest cells hold
more than its window cap, 96) at the 65,536 primary hits and at the
caustic queries of wave 0 of the render with the map, logging how far the
cap reaches, and on a dense core with a near-coincident focus whose
windows hold thousands of candidates and a second focus whose windows
pass a focal block's shared memory; the render's caustic energy with
the capped estimator (``knn_backend="jnp"``) is logged beside it.  Each
K3 query set logs how many queries each tier took (the warp tier, the
focal tier staged in shared memory, the focal tier past it) and each
tier's close fraction, and each tier's device time over K3_PROFILE_CALLS
calls; the dense-focus set must fill every tier, and in every tier each
query off the plain version must be a tie at r_k or within the float32
rounding bound of its sum (``k3_off``).
Each render is timed after a warm-up render; one Cornell render with the
map, one render of the largest terrain and one of the glass box, and one
chunk (``ray_chunk`` slots) of the Cornell and glass photon passes, are
then profiled (device ms per kernel and the device's busy share).
Every phase prints its seconds; any failure raises, and the script exits
non-zero.  It needs a CUDA device and never falls back to the CPU.

The last lines of its output are one JSON object with each kernel's launch
count on the main paths, its largest difference from the plain version,
its time, the plain version's, and the bound (the least time the card
could take for the same work); the card's name and power limit as
nvidia-smi prints them; and ``{"ok": true, "device": {...}}``.

``--cornell TREE`` builds the kernels of the port in the checkout TREE
(an unpacked ``git archive`` of any commit of the port, this one or an
older one) and runs only the Cornell path and K1's time on one of its
512x512 waves, with this script's code, so that two trees are timed by
the same code in processes that take turns on one card.  K3 is timed
there on the primary hits, on wave 0's caustic queries and on the
bench's 262,144 points, by CUDA events, by the host's time to issue a
call and by its device time a call (torch.profiler, which leaves out the
host's gaps), and inside one render with the map by the host's time in
each call; on a tree whose K3 has two tiers each set also logs its
tiers.  ``--glass TREE`` runs phase B alone in the same way: the glass
box's build, photon pass and map, a warm-up render and GLASS_RENDERS
timed renders with the map.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")

SEED = 0
WIDTH = HEIGHT = 512
SPP = 8
DEPTH = 8
PHOTONS = 750_000
KNN_K = 32
CORNELL_RENDERS = 4        # renders with the map and as many without
# phase A (scripts/bench_big_scenes.py's terrain) and phase B
BIG_SIZE, BIG_SPP, BIG_DEPTH = 256, 2, 3
GLASS_SIZE, GLASS_SPP, GLASS_DEPTH = 256, 4, 8
GLASS_PHOTONS = 250_000
GLASS_RENDERS = 5          # timed phase B renders of --glass TREE
K4_RAYS = 16_384            # wave-0 primary rays, and as many random rays
# K3 dense-focus check: core and background photons, queries; a near-
# coincident focus (photons, sigma) and queries inside it
DENSE_CORE, DENSE_BACKGROUND, DENSE_QUERIES = 200_000, 50_000, 16_384
DENSE_FOCUS, DENSE_FOCUS_SIGMA, DENSE_FOCUS_QUERIES = 20_000, 1e-4, 1_024
KNN_BUDGET = 2048          # the JAX router's per-point window budget
# and a focus past a K3 focal block's staged capacity: that many
# photons more than the capacity, and queries inside it
DENSE_SPILL_EXTRA, DENSE_SPILL_QUERIES = 12_000, 256
K3_PROFILE_CALLS = 20      # K3 calls a profile of each query set
K3_HOST_CALLS = 200        # K3 calls issued back to back for the host time

# gates of the kernel-against-plain comparisons (the fractions are of lanes)
K2_PRIM_EQUAL = 0.999      # prim ids equal (FMA flips borderline accepts)
K2_T_RTOL = 1e-5
K4_NEAR_TIE = 2.0 ** -7    # winners this close in t are counted near ties
K4_TESTS_RTOL = 1e-3       # ray-triangle tests made, against the plain walk
K1_LANE_TOL = 1e-4         # a lane is off when any channel is off by more
K1_MAX_OFF = 0.001         # fewer than 0.1% of lanes off
K1_COUNT_RTOL = 5e-4       # closest / shadow ray counts
K3_RTOL, K3_ATOL = 2e-4, 1e-6
K3_CLOSE = 0.999
K3_DENSE_WINDOW = 512      # dense-focus queries: windows past this many
# K1's second scene: the Cornell box with its glass sphere subdivided 5
# times, whose feature table (66 chunks) does not fit shared memory
K1_GLASS_SUBDIVS, K1_GLASS_TRIS, K1_GLASS_PHOTONS = 5, 8342, 50_000
MIN_STORED = 0.98          # of the photon slots
# adaptive renders (phase C and K1's block-adaptive gate): the
# RenderConfig defaults, which are the reference's (util.h:24-26)
ADAPT_MIN, ADAPT_MAX, ADAPT_THRESH = 8, 32, 0.0015
# phase D: scripts/validate_golden.py's cornell_fog scene and budget
FOG = dict(pos=(4.0, 3.4, 0.0), size=(16.0, 8.0, 8.4), col=(1.0, 1.0, 1.0),
           density=0.05, scatter=0.5, noise_scale=2)
FOG_AMBIENT = (0.35, 0.35, 0.35)
FOG_SPP, FOG_DEPTH = 4, 6
FOG_MIN_DIFF = 1e-3        # mean |fog - no fog| (tests/test_atmosphere.py)
CLI_SIZE, CLI_PHOTONS = 128, 20_000
# the CLI's scene: every new directive but imTex (the card host has no
# Pillow); 2 to 4 samples, so the checkpoint after wave 0 is mid-render
CLI_SCENE = """colorTex 0.9 0.9 0.9
colorTex 0 0 0
colorTex 0.8 0.3 0.2
mat 0 1 1 1
mat 2 1 1 1
mat 0 1 0 0 1.5
box 0 -3 0 8 0.2 8 0 0 0 0
box 0 0 4 8 8 0.2 0 0 0 0
sphere -1 -1.6 0 1.2 2
cone 1.6 -2.9 0.8 1.5708 0 0 0.7 1.6 1
heightFog 0 0 0 8 6 8 0.9 0.9 0.9 0.2 1 2
light 0 3 -1 8 8 8 0.3
samples 2 4 0.01
photons 20000
camera 0 0 -9 0 -1 0
"""

# the gradient phase: bench.py's train step (bench.py:121-187), the mesh
# Cornell box at 256x256, 1 spp, depth 8 on the staged wave, a map of the
# first 50,000 slots of the main path's photon batch, loss mean((c -
# 0.25)^2), gradients to the photon colours and the light colour
GRAD_SIZE, GRAD_DEPTH, GRAD_PHOTONS, GRAD_TARGET = 256, 8, 50_000, 0.25
GRAD_REPEATS = 3           # timed steps after the driven one (the warm-up)
# the step's gradients with the kernels' forward against the plain
# forward's: relative L2 difference of each gradient (a lane whose hit or
# k-th neighbour the kernel and the plain version pick differently, fewer
# than 0.1% of lanes, feeds other gradients) and of the loss
GRAD_CMP_RTOL, GRAD_LOSS_RTOL = 1e-2, 1e-3
# gradcheck's FD gates (tests/test_gradients.py): IOR 5e-2, the rest 1e-2
GRADCHECK_TOL = {"ior": 5e-2}
# cli grad-check's scene: a closed box, one wall carrying a committed PNG
# (written by Pillow, with row filters) as an image texture
GRAD_CLI_SCENE = """imTex tex.png 2 2
colorTex 0.9 0.9 0.9
colorTex 0 0 0
colorTex 0.8 0.2 0.2
mat 1 2 1 1
mat 0 2 1 1
mat 3 2 0.5 1
box 0 0 0 8 8 8 0 0 0 0
box 0 0 3.9 6 6 0.1 0 0 0 1
box 1 -3 1 1.5 2 1.5 0 0.4 0 2
light 0 3 0 4 4 4 0.3
camera 0 0 -3.5 0 0 0
"""
GRAD_CLI_TEXTURE = os.path.join("docs", "validation", "cornell_ours.png")

# the bench phase: the port's bench in a subprocess, one timed run a metric
# after its warm-up; its five lines, in the root bench.py's order
BENCH_METRICS = ["photons_emitted_per_s", "knn_gather_mphotons_per_s",
                 "train_step_seconds",
                 "rays_per_s_cornell_512_8spp_nophotons",
                 "rays_per_s_cornell_512_8spp"]
BENCH_REPEATS, BENCH_TIMEOUT = 1, 300
# the distribution phase: two ranks sharing the card over gloo, the main
# path's photon pass (PHOTONS / DIST_RANKS slots a rank), its render split
# by rows, and the train step split by rays, each against the single
# process (positions rtol 1e-6, image max error 1e-5, step rel 1e-5: the
# loss, and each updated parameter in relative L2)
DIST_RANKS, DIST_LR, DIST_TIMEOUT = 2, 0.05, 600
DIST_POS_RTOL, DIST_IMG_ATOL, DIST_STEP_RTOL = 1e-6, 1e-5, 1e-5

# the card's peak rates for the bound (H100 SXM datasheet)
PEAK_FP32 = 67e12          # FP32 operations per second outside tensor cores
PEAK_BYTES = 3.35e12       # device memory bytes per second
# FP32 arithmetic of one ray-triangle test (csrc/common.cuh gi_tri_test:
# m 5, |det| 1, u 11, v 11, t 6, homogeneous signs 3, u+v 1, max 1,
# reciprocal 1, product 1) and of one ray-box slab test (stream.cu)
OPS_PER_TEST = 41
OPS_PER_SLAB = 27
OPS_PER_CANDIDATE = 8      # K3: d^2 of one photon (3 sub, 3 mul, 2 add)
WAVE_INPUT_CALLS = 50      # wave-inputs kernel calls timed in a row
# the fog march kernel: about 70 float operations a lane-step (the step's
# t and point, the trilinear density, its pow and falloff), timed in a row
OPS_PER_FOG_STEP = 70
FOG_MARCH_CALLS = 20


def log(*args):
    print(*args, flush=True)


def require(ok, what):
    """A gate of the run: raise (and so fail the run) unless ``ok``."""
    if not ok:
        raise RuntimeError(f"chip_smoke gate failed: {what}")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


class Phase:
    """Prints the wall seconds of a phase (synchronised) on its own line."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import torch
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        log(f"== phase {self.name}")
        return self

    def __exit__(self, *exc):
        import torch
        if exc[0] is None:
            torch.cuda.synchronize()
            secs = time.perf_counter() - self.t0
            log(f"phase {self.name} seconds {secs:.3f}")
        return False


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events, one
    warm-up call first)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_issue_ms(fn, reps):
    """Mean host milliseconds to issue one call of ``fn`` (``reps`` calls
    back to back, timed before the closing synchronize; one warm-up call
    first): what a call costs the host when the card keeps up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e3


def bound(ops, nbytes):
    """(ms, "operations" | "bytes"): the least time the card could take for
    ``ops`` FP32 operations that move ``nbytes`` bytes."""
    t_ops = ops / PEAK_FP32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed(fn):
    """(result, seconds) of ``fn()``, synchronised on both ends."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profile(name, fn, top=8, host=True, span=None):
    """Device ms per kernel over one call of ``fn`` (torch.profiler) and
    the share of its wall the device was busy (one stream: the kernels do
    not overlap); the ``top`` kernels and, whatever their rank, the port's
    own (``gi_*``).  ``host=False`` traces the device alone (for long runs
    of many small operations, such as a photon pass).  The device events
    are summed from the profiler's raw records, which is fast where
    ``key_averages`` would take minutes over a photon pass's events.
    ``span``: the name of a ``record_function`` range; the device time of
    the kernels launched inside it is logged too.  Returns (busy device
    ms, the span's device ms or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as trace
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.insert(0, ProfilerActivity.CPU)
    with trace(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    events = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    ranges, op_start = [], {}
    if span is not None:
        ranges = sorted((e.start_ns(), e.end_ns()) for e in events
                        if e.device_type() == cpu and e.name() == span)
        op_start = {e.correlation_id(): e.start_ns() for e in events
                    if e.device_type() == cpu}
    in_span = 0.0
    for e in events:
        # the device-side copy of a record_function range is no kernel
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation() and e.name() != span):
            # no namespace qualifier, no argument list
            key = e.name().replace("(anonymous namespace)::", "") \
                .split("(")[0]
            ms = e.duration_ns() / 1e6
            kernels[key] = kernels.get(key, 0.0) + ms
            # a kernel belongs to the span if the op that launched it
            # started inside one of the span's ranges
            t = op_start.get(e.linked_correlation_id())
            if t is not None and any(a <= t <= b for a, b in ranges):
                in_span += ms
    busy = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    ours = {k: round(v, 3) for k, v in kernels.items()
            if k.removeprefix("void ").startswith("gi_")}
    log(f"profile {name}: wall ms {wall:.1f} device busy ms {busy:.1f} "
        f"({busy / wall:.4f}); kernels ms "
        + json.dumps({k: round(v, 3) for k, v in ranked})
        + f"; the port's kernels ms {json.dumps(ours)}")
    if span is None:
        return busy, None
    log(f"profile {name}: {span} {len(ranges)} ranges, device ms "
        f"{in_span:.1f} ({in_span / max(busy, 1e-9):.4f} of the busy device "
        f"time)")
    return busy, in_span


def hit_gates(name, scene, ro, rd, p_k, p_ref, eps):
    """Prim ids, hit masks and exact t of kernel winners ``p_k`` against
    reference winners ``p_ref``.  Lanes whose winners differ in t by more
    than rtol K2_T_RTOL but within K4_NEAR_TIE are counted as near ties
    (the approximate ordering t); every other lane must agree.  Returns the
    largest absolute exact-t difference."""
    from gi_raytracer_tpu_torch.ops.intersect import exact_hit
    t_k, _, _, p_k = exact_hit(scene, ro, rd, p_k, eps)
    t_r, _, _, p_ref = exact_hit(scene, ro, rd, p_ref, eps)
    both = (p_k >= 0) & (p_ref >= 0)
    rel = ((t_k - t_r).abs() / t_r.abs())[both]
    near = ((rel > K2_T_RTOL) & (rel <= K4_NEAR_TIE)).sum().item()
    far = (rel > K4_NEAR_TIE).sum().item()
    prim_eq = (p_k == p_ref).float().mean().item()
    mask_eq = ((p_k >= 0) == (p_ref >= 0)).float().mean().item()
    log(f"{name}: rays {p_k.shape[0]} hits {both.float().mean().item():.4f} "
        f"prim equal {prim_eq:.6f} hit mask equal {mask_eq:.6f} exact t "
        f"max rel err {rel.max().item() if rel.numel() else 0.0:.3e} near "
        f"ties {near} beyond {far}")
    require(prim_eq >= K2_PRIM_EQUAL, (name, prim_eq))
    require(mask_eq >= K2_PRIM_EQUAL, (name, mask_eq))
    require(far == 0, (name, "exact t off beyond near ties", far))
    require(near <= (1 - K2_PRIM_EQUAL) * p_k.shape[0], (name, near))
    return (t_k - t_r).abs()[both].max().item() if both.any() else 0.0


def save_png(renderer, img, name):
    from gi_raytracer_tpu_torch.io import save_png as write_png
    png = os.path.join(OUT_DIR, name)
    write_png(png, renderer.tonemap(img))
    log(f"image mean {img.mean().item():.5f} saved {png}")


def blocks_never_grow(blocks):
    """The active blocks of an adaptive render never increase."""
    return all(a >= b for a, b in zip(blocks, blocks[1:]))


def walls_gate(img, size):
    """The red wall (world +x) on the image's left, the blue on its right,
    and the left wall redder than the right."""
    mid = slice(size * 2 // 5, size * 3 // 5)
    left = img[mid, size // 5:size * 3 // 10].mean((0, 1))
    right = img[mid, size * 7 // 10:size * 4 // 5].mean((0, 1))
    log(f"left wall rgb {left.tolist()} right wall rgb {right.tolist()}")
    require(left[0] > left[2] and right[2] > right[0], (left, right))
    require(left[0] / left[2] > right[0] / right[2],
            "left wall redder than the right wall")


def k1_wave(scene, cfg, cam):
    """K1 at the Cornell path's shape, one 512x512 wave without the map:
    ((ro, rd, sx, sy, lane) of the wave, its closest-hit rays, mean ms)."""
    import torch
    from gi_raytracer_tpu_torch.ops.cuda_megakernel import radiance_wave_mega
    from gi_raytracer_tpu_torch.render import Renderer
    ro, rd, sx, sy = Renderer(scene, cam, cfg, WIDTH, HEIGHT).wave_inputs(0)
    lane = torch.arange(ro.shape[0], device=ro.device)
    wave = (ro, rd, sx, sy, lane)
    _, (n_closest, _) = radiance_wave_mega(scene, cfg, *wave[:4], lane, 0,
                                           None)
    ms = cuda_ms(lambda: radiance_wave_mega(scene, cfg, *wave[:4], lane, 0,
                                            None), 5)
    return wave, int(n_closest), ms


def wave_inputs_row(scene, cam):
    """The wave-inputs kernel against its plain version
    (``Renderer.wave_inputs_plain``: ``HaltonSampler.sample`` of every dim
    and ``primary_rays``) on wave 0 of the render cells' shapes, 512x512
    at depth 8 and 256x256 at depth 3: every output bit-equal, the
    kernel's device ms a call (torch.profiler over WAVE_INPUT_CALLS
    calls), CUDA-event ms of back-to-back calls (the host's pace) and the
    plain version's, beside the bound of its output bytes.  Returns the
    kernels-table row of the 512x512 wave."""
    import torch
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.ops import _cuda
    from gi_raytracer_tpu_torch.render import Renderer
    row = None
    for size, depth in ((WIDTH, DEPTH), (256, 3)):
        r = Renderer(scene, cam, RenderConfig(min_samples=SPP,
                                              max_samples=SPP,
                                              max_depth=depth), size, size)
        frame = r.frame_routes()
        require(frame.inputs == "kernel", ("wave inputs route", size, depth))

        def call():
            return r.wave_inputs(0, frame=frame)

        n0 = _cuda.launches["wave_inputs"]
        got = call()
        require(_cuda.launches["wave_inputs"] == n0 + 1, "one launch")
        want = r.wave_inputs_plain(r.halton_index(0))
        same = all(torch.equal(g.contiguous().view(torch.int32),
                               w.contiguous().view(torch.int32))
                   for g, w in zip(got, want))
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        label = f"{size}x{size} depth {depth}"
        device = profile(f"wave inputs {label}, {WAVE_INPUT_CALLS} calls",
                         lambda: [call() for _ in range(WAVE_INPUT_CALLS)],
                         host=False)[0] / WAVE_INPUT_CALLS
        ms = cuda_ms(call, WAVE_INPUT_CALLS)
        plain_ms = cuda_ms(lambda: r.wave_inputs_plain(r.halton_index(0)),
                           5)
        b_ms, b_by = bound(0, size * size * 4 * (2 * depth + 3))
        log(f"wave inputs {label}: bit-equal {same} (largest difference "
            f"{err:.3e}); device ms a call {device:.4f}, CUDA-event ms "
            f"{ms:.4f}, plain ms {plain_ms:.3f}; bound ms {b_ms:.4f} "
            f"({b_by}: the outputs)")
        require(same, ("wave inputs bit-equal", label))
        if row is None:
            row = dict(name="wave_inputs", route="cuda",
                       source="gi_raytracer_tpu_torch/csrc/wave_inputs.cu",
                       replaces=None, max_abs_err=err, ms=device,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
    return row


def fog_march_row(fog, cam, cfg):
    """The fog march kernel against its plain version (``_march``, the
    blocked torch march) and the step loop on wave 0's primary rays of the
    fog render (512x512, each marched to its closest hit): found and t_hit
    bit-equal, the kernel's device ms a call (torch.profiler over
    FOG_MARCH_CALLS calls), the plain version's CUDA-event ms, and the
    bound of the lane-steps it counts (OPS_PER_FOG_STEP operations each).
    Returns the kernels-table row."""
    import torch
    from gi_raytracer_tpu_torch import routes
    from gi_raytracer_tpu_torch.ops import _cuda, cuda_fog, intersect
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render import atmosphere as atm
    ro, rd, _, _ = Renderer(fog, cam, cfg, WIDTH, HEIGHT).wave_inputs(0)
    hit = intersect.trace_closest(fog, ro, rd)
    t_cap = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    tmin, tmax, has = atm._fog_bounds(fog, ro, rd, t_cap)
    lane = torch.arange(ro.shape[0], device=ro.device)
    args = (ro, rd, tmin, tmax, has, 31337)
    require(routes.fog_march(fog, cfg, ro, rd) == ("kernel", []),
            "fog march route")

    def call():
        return atm.march(fog, cfg, *args, ray_id=lane)

    n0 = _cuda.launches["fog_march"]
    got = call()
    require(_cuda.launches["fog_march"] == n0 + 1, "one launch a march")
    want = atm._march(fog, cfg, *args, ray_id=lane)
    steps = atm._march_steps(fog, cfg, *args, ray_id=lane)
    same = all(torch.equal(got[0], w[0]) and torch.equal(
        got[1].view(torch.int32), w[1].view(torch.int32))
        for w in (want, steps))
    err = (got[1] - want[1]).abs().max().item()
    counts = torch.zeros(3, dtype=torch.int64, pin_memory=True)
    cuda_fog.march(fog.fog, ro, rd, tmin + cfg.shadow_bias, tmax, has, lane,
                   31337, cfg.raymarch_stepsize, cfg.raymarch_max_steps,
                   atm.MARCH_BLOCK, counts.data_ptr())
    torch.cuda.synchronize()
    lanes, lane_steps, blocks = counts.tolist()
    device = profile(f"fog march, {FOG_MARCH_CALLS} calls",
                     lambda: [call() for _ in range(FOG_MARCH_CALLS)],
                     host=False)[0] / FOG_MARCH_CALLS
    plain_ms = cuda_ms(lambda: atm._march(fog, cfg, *args, ray_id=lane), 3)
    b_ms, b_by = bound(lane_steps * OPS_PER_FOG_STEP,
                       ro.shape[0] * (24 + 4 + 4 + 1 + 8 + 5))
    log(f"fog march {WIDTH}x{HEIGHT} primary rays: {lanes} lanes marching, "
        f"{blocks} blocks, {lane_steps} lane-steps, scattered "
        f"{int(got[0].sum())}; bit-equal {same} (largest t difference "
        f"{err:.3e}); device ms a call (march and t_hit) {device:.4f}, "
        f"plain ms {plain_ms:.3f}; bound ms {b_ms:.4f} ({b_by}); "
        f"{json.dumps(cuda_fog.march_info(fog.fog.grid.shape))}")
    require(same, "fog march bit-equal")
    return dict(name="fog_march", route="cuda",
                source="gi_raytracer_tpu_torch/csrc/fog.cu", replaces=None,
                max_abs_err=err, ms=device, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def k3_queries(scene, cfg, cam):
    """The first 65,536 hit points of one 512x512 Cornell wave's primary
    rays and their directions back to the camera: K3's queries."""
    import torch
    from gi_raytracer_tpu_torch.ops.intersect import trace_closest
    from gi_raytracer_tpu_torch.render import Renderer
    ro, rd, _, _ = Renderer(scene, cam, cfg, WIDTH, HEIGHT).wave_inputs(0)
    hit = trace_closest(scene, ro, rd)
    ok = torch.nonzero(hit.prim >= 0).squeeze(1)[:65536]
    require(ok.numel() == 65536, ok.numel())
    return ((ro[ok] + hit.t[ok, None] * rd[ok]).contiguous(),
            (-rd[ok]).contiguous())


def k3_bench_points(scene, cfg, cam):
    """The 262,144 points at which the port's bench times the caustic
    estimate (``bench.py`` ``knn_gather_mphotons_per_s``): every primary
    ray of one 512x512 wave, at its first hit or, on a miss, its origin."""
    import torch
    from gi_raytracer_tpu_torch.ops.intersect import trace_closest
    from gi_raytracer_tpu_torch.render import Renderer
    ro, rd, _, _ = Renderer(scene, cam, cfg, WIDTH, HEIGHT).wave_inputs(0)
    hit = trace_closest(scene, ro, rd)
    pts = ro + torch.where(hit.prim >= 0, hit.t, 0.0)[:, None] * rd
    return pts.contiguous(), (-rd).contiguous()


def k3_wave_queries(scene, cfg, cam, pm):
    """The caustic queries K3 answers in wave 0 of a 512x512 Cornell render
    with the map (K1's query records, compacted; one estimate a wave on
    the card): (points, directions), recorded from the estimates."""
    import torch
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render import photon_knn
    from gi_raytracer_tpu_torch.render.integrator import dispatch_wave
    ro, rd, sx, sy = Renderer(scene, cam, cfg, WIDTH, HEIGHT).wave_inputs(0)
    lane = torch.arange(ro.shape[0], device=ro.device)
    calls = []
    estimate = photon_knn._estimate

    def record(pm_, point, direction, k):
        calls.append((point.clone(), direction.clone()))
        return estimate(pm_, point, direction, k)

    photon_knn._estimate = record
    try:
        dispatch_wave(scene, cfg, ro, rd, sx, sy, 0, pm, lane_ids=lane,
                      route="k1")
    finally:
        photon_knn._estimate = estimate
    require(len(calls) > 0, "no caustic estimate in the wave")
    return (torch.cat([c[0] for c in calls]).contiguous(),
            torch.cat([c[1] for c in calls]).contiguous())


def k3_host_in_render(scene, cfg, cam, pm):
    """(K3 calls, host ms spent in them, render seconds) of one 512x512
    render with the map: each caustic estimate timed on the host clock
    without a sync, which is what the host pays to issue it."""
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render import photon_knn
    estimate = photon_knn._estimate
    spent = []

    def timed_estimate(*args):
        t0 = time.perf_counter()
        out = estimate(*args)
        spent.append(time.perf_counter() - t0)
        return out

    photon_knn._estimate = timed_estimate
    try:
        r = Renderer(scene, cam, cfg, WIDTH, HEIGHT, photon_map=pm)
        _, secs = timed(r.render)
    finally:
        photon_knn._estimate = estimate
    require(len(spent) > 0, "no caustic estimate in the render")
    return len(spent), sum(spent) * 1e3, secs


def k3_window_stats(pm, pts):
    """(stats, candidates a query) of the window cap on a map and its
    queries: the densest cell, the share of stored photons in cells past
    ``pm.window_cap`` and past the first ``window_cap`` of their cell, the
    share of queries whose window holds such a cell, the largest window,
    and the queries past KNN_BUDGET candidates (where the JAX router falls
    back to its capped estimator; K3 counts the whole window)."""
    import torch
    from gi_raytracer_tpu_torch.render.photon_knn import _cells, _window
    occ = pm.cell_start[1:] - pm.cell_start[:-1]
    cap = int(pm.window_cap)
    stored = max(int(occ.sum()), 1)
    cand = torch.zeros(pts.shape[0], dtype=torch.int64, device=pts.device)
    capped = torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)
    for start, end, dup in _window(pm, _cells(pm, pts)):
        cnt = torch.where(dup, 0, end - start)
        cand += cnt
        capped |= cnt > cap
    return dict(
        densest_cell=int(occ.max()), window_cap=cap,
        photons_in_cells_over_cap=int(occ[occ > cap].sum()) / stored,
        photons_past_cap=int(torch.clamp(occ - cap, min=0).sum()) / stored,
        queries=pts.shape[0],
        queries_with_capped_cell=capped.float().mean().item(),
        largest_window=int(cand.max()),
        windows_past_budget=int((cand > KNN_BUDGET).sum())), cand


def k3_bytes(pm, pts, k):
    """(bytes, parts) K3 must move to answer these queries: each query's
    point and direction read (24 bytes) and its estimate written (12);
    for the queries short of the far sentinel, each distinct cell_start
    entry of their windows (4), the position and valid flag of each
    distinct photon in those cells (13), and the direction and colour of
    each distinct photon within some query's r_k (24).  What the run's
    data needs, not the whole map."""
    import torch
    from gi_raytracer_tpu_torch.render.photon_knn import (
        FAR, _cells, _d2, _plain_blocks, _window_takes)
    near = pts[:, 0] < FAR
    nx, ny, nz = pm.dims
    gi = _cells(pm, pts[near])
    cids = []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                w = gi + torch.tensor([ox, oy, oz], device=pts.device)
                inside = ((w >= 0) & (w < torch.tensor(
                    pm.dims, device=pts.device))).all(1)
                w = w[inside]
                cids.append((w[:, 0] * ny + w[:, 1]) * nz + w[:, 2])
    cells = torch.unique(torch.cat(cids))
    entries = torch.unique(torch.cat([cells, cells + 1])).numel()
    photons = int((pm.cell_start[cells + 1] - pm.cell_start[cells]).sum())
    # the photons within r_k (d^2 <= the rank-th smallest, rank = min(k,
    # found)), every block of candidates laid out as the plain version does
    within = torch.zeros(pm.capacity, dtype=torch.bool, device=pts.device)
    for ids in _plain_blocks(pm, pts, k):
        start, _, take = _window_takes(pm, pts[ids])
        end = torch.cumsum(take, 1)
        n_got = end[:, -1]
        m = torch.arange(int(n_got.max()), device=pts.device) \
            .expand(ids.shape[0], -1).contiguous()
        cell = torch.clamp(torch.searchsorted(end, m, right=True), max=26)
        idx = torch.clamp(torch.gather(start, 1, cell) + m
                          - torch.gather(end - take, 1, cell),
                          0, pm.capacity - 1)
        ok = (m < n_got[:, None]) & pm.valid[idx]
        d2 = torch.where(ok, _d2(pm.pos[idx] - pts[ids][:, None, :]),
                         torch.inf)
        rank = torch.clamp(ok.sum(1), 1, k)
        rk2 = torch.gather(torch.sort(d2, 1).values, 1, rank[:, None] - 1)
        within[idx[ok & (d2 <= rk2)]] = True
    parts = dict(queries=pts.shape[0], cell_start_entries=entries,
                 window_photons=photons, photons_within_rk=int(within.sum()))
    return (pts.shape[0] * (24 + 12) + entries * 4 + photons * 13
            + parts["photons_within_rk"] * 24), parts


def sum_rounding(n):
    """gamma_n = n u / (1 - n u), u = 2^-24: a float32 sum of n products,
    in any order, lies within gamma_n * sum |product| of the exact sum."""
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def k3_off(pm, pts, dirs, k, got, want):
    """Why queries found off the plain version are off, one at a time (for
    the few that are): (tied, cancel, within) a query.  ``tied``: its k-th
    and (k+1)-th nearest window candidates lie at the same d^2, a tie at
    r_k, where K3 counts every photon within r_k (as the TPU kernels do)
    and the plain version the first k by candidate order.  ``cancel``:
    |sum| / sum |term| of its k nearest photons' weighted colours, the
    least of the three channels; near 0 the sum's last bits depend on its
    order, which differs between K3 and the plain version.  ``within``:
    each channel of |got - want| is inside the K3 tolerance plus both sums'
    float32 rounding bound, 2 gamma_(n+3) sum |col| sum_c |dir_c qdir_c|
    over the n photons within r_k, over pi r_k^2 (``sum_rounding``; the 3
    for the weight's dot product)."""
    import torch
    from gi_raytracer_tpu_torch.render.photon_knn import _d2, _window_takes
    start, _, take = _window_takes(pm, pts)
    out = []
    for i in range(pts.shape[0]):
        idx = torch.cat([torch.arange(a, a + n, device=pts.device)
                         for a, n in zip(start[i].tolist(),
                                         take[i].tolist())])
        idx = idx[pm.valid[idx]]
        d2, order = torch.sort(_d2(pm.pos[idx] - pts[i]), stable=True)
        near = idx[order[:k]]
        terms = pm.col[near] * (pm.dir[near] @ dirs[i])[:, None]
        cancel = (terms.sum(0).abs()
                  / terms.abs().sum(0).clamp(min=1e-30)).min().item()
        rk2 = d2[min(k, d2.shape[0]) - 1]
        sel = idx[order[d2 <= rk2]]
        mag = (pm.col[sel].abs()
               * (pm.dir[sel].abs() @ dirs[i].abs())[:, None]).sum(0)
        bound = (2 * sum_rounding(sel.shape[0] + 3) * mag
                 / (np.pi * rk2.clamp(min=1e-20)))
        err = (got[i] - want[i]).abs()
        within = bool((err <= K3_ATOL + K3_RTOL * want[i].abs()
                       + bound).all())
        out.append((d2.shape[0] > k and bool(d2[k - 1] == d2[k]), cancel,
                    within))
    return out


def k3_tiers(label, pm, pts, dirs, cand, got=None, want=None):
    """How many queries each tier of K3 took: the warp tier
    (windows of at most ``photon_knn.FOCAL`` candidates, empty windows and
    far sentinels), the focal tier with the window staged in a block's
    shared memory, and the focal tier past that capacity; the focal count
    is the kernel's own queue (``knn_counts``), gated against the windows.
    With K3's estimates ``got`` and the plain version's ``want`` each
    tier's close fraction (within the K3 tolerance) is logged, and for its
    queries off the plain version how many have a tie at r_k and how far
    their sums cancel (``k3_off``); each of those must be a tie or within
    the rounding bound.  Returns the three counts."""
    from gi_raytracer_tpu_torch.render.photon_knn import (
        FAR, FOCAL, knn_counts, knn_info, sample_photons_tiled)
    sample_photons_tiled(pm, pts, dirs, KNN_K)
    queued, taken = knn_counts(pm)
    info = knn_info()
    cap = info["staged_capacity"]
    live = pts[:, 0] < FAR
    tiers = {"warp": ~live | (cand <= FOCAL),
             "focal staged": live & (cand > FOCAL) & (cand <= cap),
             "focal past capacity": live & (cand > cap)}
    counts = {name: int(t.sum()) for name, t in tiers.items()}
    close = None if got is None else (
        (got - want).abs() <= K3_ATOL + K3_RTOL * want.abs()).all(-1)
    parts = []
    for name, t in tiers.items():
        part = f"{name} {counts[name]}"
        if close is not None and counts[name]:
            part += f" close {close[t].float().mean().item():.6f}"
            off = t & ~close
            if off.any():
                why = k3_off(pm, pts[off], dirs[off], KNN_K, got[off],
                             want[off])
                part += (f" ({len(why)} off: {sum(w[0] for w in why)} tied "
                         f"at r_k, |sum| / sum |term| down to "
                         f"{min(w[1] for w in why):.2e}, "
                         f"{sum(w[2] for w in why)} within the rounding "
                         f"bound)")
                require(all(w[0] or w[2] for w in why),
                        (label, name, "off, untied, past the rounding "
                         "bound", why))
        parts.append(part)
    log(f"K3 {label}: tiers (threshold {FOCAL}, staged capacity {cap}): "
        + ", ".join(parts) + f"; queued by the kernel {queued}, taken "
        f"{taken}")
    require(queued == counts["focal staged"] + counts["focal past capacity"],
            (label, queued, counts))
    require(taken == queued + info["focal"]["grid"], (label, taken, queued))
    return counts


def k3_device_ms(label, fn):
    """The card's busy ms a call of ``fn`` over K3_PROFILE_CALLS calls in a
    row (torch.profiler: every kernel each call launches, and not the
    host's gaps between them, which CUDA events over a short launch
    count); each kernel's share is logged."""
    busy, _ = profile(f"K3 {label}, {K3_PROFILE_CALLS} calls",
                      lambda: [fn() for _ in range(K3_PROFILE_CALLS)],
                      host=False)
    return busy / K3_PROFILE_CALLS


def glass_path(glass, glass_cfg, cam, renders=1):
    """Phase B on the glass box: a photon pass, its map, a warm-up render
    and ``renders`` timed renders with the map (each logged, and their
    median); gates the photons stored and each image; returns the renderer
    and the last image."""
    import torch
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons)
    gmin = glass.world_min.cpu().numpy()
    gmax = glass.world_max.cpu().numpy()
    batch, t_ph = timed(lambda: trace_photons(glass, glass_cfg))
    stored = int(batch.stored.sum())
    gpm, t_map = timed(lambda: build_photon_map(batch, gmin, gmax))
    log(f"phase B photons stored {stored} of {GLASS_PHOTONS} "
        f"({stored / GLASS_PHOTONS:.5f}) in {t_ph:.3f} s: "
        f"{GLASS_PHOTONS / t_ph:.1f} photon slots/s; map {gpm.dims} "
        f"window_cap {gpm.window_cap} built in {t_map:.3f} s")
    require(stored >= MIN_STORED * GLASS_PHOTONS, stored)
    r = Renderer(glass, cam, glass_cfg, GLASS_SIZE, GLASS_SIZE,
                 photon_map=gpm)
    r.render()                                          # warm-up
    rates = []
    for _ in range(renders):
        (img, st), secs = timed(lambda: r.render(return_state=True))
        rays = float(st["rays"])
        rates.append(rays / secs)
        log(f"phase B render {GLASS_SIZE}x{GLASS_SIZE} {GLASS_SPP} spp "
            f"depth {GLASS_DEPTH} with the map: {rays:.0f} rays in "
            f"{secs:.3f} s, {rays / secs:.1f} rays/s")
        require(img.shape == (GLASS_SIZE, GLASS_SIZE, 3), img.shape)
        require(torch.isfinite(img).all(), "finite glass image")
        walls_gate(img, GLASS_SIZE)
    if renders > 1:
        log(f"phase B renders with the map: median "
            f"{statistics.median(rates):.1f} rays/s of {renders}")
    return r, img


def glass_alone(cam):
    """``--glass TREE``: the glass box built from TREE's code, then phase B
    with GLASS_RENDERS timed renders."""
    import torch
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
    from gi_raytracer_tpu_torch.scene.cornell import (
        GLASS_SUBDIVS, GLASS_TRIS, cornell_box)
    glass_cfg = RenderConfig(min_samples=GLASS_SPP, max_samples=GLASS_SPP,
                             adaptive=False, max_depth=GLASS_DEPTH,
                             photons=GLASS_PHOTONS, knn_k=KNN_K, seed=SEED)
    with Phase("glass build"):
        glass, t_build = timed(lambda: cornell_box(
            SceneBuilder, meshgen, True, GLASS_SUBDIVS).build(
                device=torch.device("cuda", 0)))
        require(glass.n_tris == GLASS_TRIS, glass.n_tris)
        log(f"glass box {glass.n_tris} triangles built in {t_build:.3f} s")
    with Phase("phase B: high-poly glass"):
        glass_path(glass, glass_cfg, cam, GLASS_RENDERS)


def cornell_path(scene, cfg, cam):
    """The Cornell main path: a photon pass, its map, a warm-up render each
    way, then CORNELL_RENDERS renders with the map and as many without
    it, in turns.  Logs each render and the median rays/s of each way,
    gates the photons stored, the images and the walls, and returns the
    photon map and the photon batch it was built from."""
    import torch
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons)
    batch, t_photons = timed(lambda: trace_photons(scene, cfg))
    stored = int(batch.stored.sum())
    pm, t_map = timed(lambda: build_photon_map(
        batch, scene.world_min.cpu().numpy(), scene.world_max.cpu().numpy()))
    log(f"photons stored {stored} of {PHOTONS} ({stored / PHOTONS:.5f}) in "
        f"{t_photons:.3f} s: {PHOTONS / t_photons:.1f} photon slots/s, "
        f"{stored / t_photons:.1f} stored photons/s; map {pm.dims} "
        f"window_cap {pm.window_cap} built in {t_map:.3f} s")
    require(stored >= MIN_STORED * PHOTONS, stored)
    ways = {"with": Renderer(scene, cam, cfg, WIDTH, HEIGHT, photon_map=pm),
            "without": Renderer(scene, cam, cfg, WIDTH, HEIGHT)}
    rates = {label: [] for label in ways}
    imgs = {}
    for r in ways.values():
        r.render()                                          # warm-up
    for _ in range(CORNELL_RENDERS):
        for label, r in ways.items():
            (img, st), secs = timed(lambda: r.render(return_state=True))
            rays = float(st["rays"])
            log(f"render {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH} {label} "
                f"map: {rays:.0f} rays in {secs:.4f} s, {rays / secs:.1f} "
                f"rays/s")
            require(img.shape == (HEIGHT, WIDTH, 3), img.shape)
            require(torch.isfinite(img).all(), "finite image")
            require(int(st["wave"]) == SPP, st["wave"])
            rates[label].append(rays / secs)
            imgs[label] = img
    log(f"Cornell render medians of {CORNELL_RENDERS}: with map "
        f"{statistics.median(rates['with']):.1f} rays/s, without "
        f"{statistics.median(rates['without']):.1f} rays/s")
    walls_gate(imgs["with"], WIDTH)
    save_png(ways["with"], imgs["with"], "cornell_512.png")
    return pm, batch


def _grad_scenes(dev):
    """tests/test_gradients.py's scenes on the card in float64, as the
    load_scene-like records gradcheck takes: the closed diffuse box, the
    box with a glass sphere, the floor quad, and (a Scene) the glass
    sphere over a floor triangle of the photon-path check."""
    import torch
    from types import SimpleNamespace
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.scene import SceneBuilder
    from gi_raytracer_tpu_torch.scene.meshgen import quad_mesh

    def record(b, cam_pos):
        return SimpleNamespace(
            scene=b.build(dtype=torch.float64, device=dev),
            config=RenderConfig(dtype="float64"), camera_pos=cam_pos,
            camera_look_at=(0.0, 0.0, 0.0))

    def box(with_glass):
        b = SceneBuilder()
        tex = [b.add_texture_const(c) for c in ((0.9, 0.9, 0.9),
                                                (0.8, 0.2, 0.2),
                                                (0.2, 0.2, 0.8), (0, 0, 0))]
        m = [b.add_material(t, tex[3], 1.0, 1.0, 1.0) for t in tex[:3]]
        s = 4.0
        for quad, mat in (
                (((-s, -s, -s), (s, -s, -s), (-s, -s, s), (s, -s, s)), m[0]),
                (((-s, s, -s), (s, s, -s), (-s, s, s), (s, s, s)), m[0]),
                (((-s, -s, s), (s, -s, s), (-s, s, s), (s, s, s)), m[0]),
                (((-s, -s, -s), (-s, -s, s), (-s, s, -s), (-s, s, s)), m[1]),
                (((s, -s, s), (s, -s, -s), (s, s, s), (s, s, -s)), m[2])):
            b.add_triangles(quad_mesh(*quad), mat_id=mat)
        if with_glass:
            b.add_sphere((0.0, -2.0, 0.0), 1.2,
                         b.add_material(tex[0], tex[3], 0.0, 0.0, 1.5))
        b.add_light((0.0, 3.0, 0.0), (8.0, 8.0, 8.0), 0.3)
        return record(b, (0.0, 0.0, -14.0))

    b = SceneBuilder()
    m = b.add_material(b.add_texture_const((0.9, 0.9, 0.9)),
                       b.add_texture_const((0, 0, 0)), 1.0, 1.0, 1.0)
    b.add_triangles(quad_mesh((-50, 0, -50), (50, 0, -50), (-50, 0, 50),
                              (50, 0, 50)), mat_id=m)
    b.add_light((0.0, 8.0, 0.0), (20.0, 20.0, 20.0), 0.3)
    floor = record(b, (0.0, 5.0, -6.0))

    b = SceneBuilder()
    white = b.add_texture_const((1.0, 1.0, 1.0))
    black = b.add_texture_const((0.0, 0.0, 0.0))
    b.add_triangle([(-20, 0, -20), (20, 0, -20), (0, 0, 30)],
                   mat_id=b.add_material(white, black, 1.0, 1.0, 1.0))
    b.add_sphere((0, 2, 0), 0.7, b.add_material(white, black, 0.0, 0.0, 1.5))
    b.add_light((0, 6, 0), (10, 10, 10), 0.05)
    glass_floor = b.build(dtype=torch.float64, device=dev)
    return box(False), box(True), floor, glass_floor


def grad_phase(dev, scene, cam, cfg, batch, drive):
    """The gradient path on the card.

    * The train step of ``bench.py`` (its first rung): the mesh Cornell box
      at GRAD_SIZE^2, 1 spp, depth GRAD_DEPTH on the staged wave (K2 every
      trace, K3 every caustic estimate forward, the plain estimator's VJP
      backward), a map of the first GRAD_PHOTONS slots of the main path's
      photon batch, loss mean((c - GRAD_TARGET)^2), gradients to the
      photon colours and the light colour.  One step driven (launches
      counted; K1 must stay out), then GRAD_REPEATS timed, then one
      profiled; gates: finite gradients, both norms non-zero.
    * The same step with the plain forward (``plain=True``: the plain walk
      and autograd through the plain kNN): loss and each gradient within
      GRAD_LOSS_RTOL / GRAD_CMP_RTOL (relative L2).
    * gradcheck's seven families in float64 on the card, each rel_err under
      the JAX test's tolerance.
    * ``cli grad-check`` once, on a box with a committed PNG as an image
      texture (the card host has no Pillow)."""
    import contextlib
    import io as _io
    import shutil

    import torch
    from gi_raytracer_tpu_torch import cli, gradcheck
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.ops import _cuda
    from gi_raytracer_tpu_torch.scene.scn import load_scene
    from gi_raytracer_tpu_torch.train import TARGET, TrainStep

    require(TARGET == GRAD_TARGET, TARGET)
    step = TrainStep(scene, cam, cfg, batch, GRAD_SIZE, GRAD_DEPTH,
                     GRAD_PHOTONS)
    pm = step.photon_map
    log(f"gradient step: {GRAD_SIZE}x{GRAD_SIZE} 1 spp depth {GRAD_DEPTH}, "
        f"map of {step.n_stored} photons {pm.dims} window_cap "
        f"{pm.window_cap}")

    with Phase("gradient step"):
        loss, g_pcol, g_lcol = drive("gradient step", step,
                                     need=("intersect", "knn"),
                                     absent=("megakernel", "stream"))
        counts = {k: _cuda.launches[k] for k in ("intersect", "knn")}
        secs = [timed(step)[1] for _ in range(GRAD_REPEATS)]
        norms = (g_pcol.norm().item(), g_lcol.norm().item())
        log(f"gradient step: loss {loss.item():.9g} grad norms photon "
            f"colours {norms[0]:.9g} light colour {norms[1]:.9g}; launches "
            f"K2 {counts['intersect']} K3 {counts['knn']}; seconds "
            f"{[round(x, 4) for x in secs]} median "
            f"{statistics.median(secs):.4f} (after the driven step)")
        require(torch.isfinite(loss) and torch.isfinite(g_pcol).all()
                and torch.isfinite(g_lcol).all(), "finite gradients")
        require(norms[0] > 0 and norms[1] > 0, ("non-zero gradients", norms))
    profile("gradient step", step)

    with Phase("gradient step vs plain forward"):
        loss_p, gp_pcol, gp_lcol = step(plain=True)
        loss_k, gk_pcol, gk_lcol = step()
        rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        rel = [((a - b).norm() / b.norm()).item()
               for a, b in ((gk_pcol, gp_pcol), (gk_lcol, gp_lcol))]
        err = [(a - b).abs().max().item()
               for a, b in ((gk_pcol, gp_pcol), (gk_lcol, gp_lcol))]
        log(f"gradient step against the plain forward: loss rel err "
            f"{rel_loss:.3e}; photon colours rel L2 {rel[0]:.3e} max abs "
            f"{err[0]:.3e}; light colour rel L2 {rel[1]:.3e} max abs "
            f"{err[1]:.3e}")
        require(rel_loss <= GRAD_LOSS_RTOL, ("loss", rel_loss))
        require(max(rel) <= GRAD_CMP_RTOL, ("gradients", rel))
        del gp_pcol, gp_lcol, gk_pcol, gk_lcol

    with Phase("gradcheck families (float64)"):
        box, box_glass, floor, glass_floor = _grad_scenes(dev)
        reps = [fn(box_glass if name == "ior" else
                   floor if name == "vertices" else box)
                for name, fn in gradcheck.ALL_CHECKS.items()]
        photon_cfg = RenderConfig(photons=512, photon_depth=5,
                                  dtype="float64")
        reps.append(gradcheck.check_light_color_through_photons(
            glass_floor, photon_cfg))
        for rep in reps:
            tol = GRADCHECK_TOL.get(rep.name, 1e-2)
            log(f"gradcheck {rep.name}: rel_err {rep.rel_err:.3e} (gate "
                f"{tol}) analytic {np.asarray(rep.analytic).tolist()} fd "
                f"{np.asarray(rep.fd).tolist()}")
            require(rep.rel_err < tol, (rep.name, rep.rel_err))
            require(np.abs(rep.analytic).max() > 0, (rep.name, "zero"))

    with Phase("cli grad-check"), tempfile.TemporaryDirectory() as tmp:
        shutil.copy(os.path.join(HERE, GRAD_CLI_TEXTURE),
                    os.path.join(tmp, "tex.png"))
        scn = os.path.join(tmp, "grad.scn")
        with open(scn, "w") as f:
            f.write(GRAD_CLI_SCENE)
        require(load_scene(scn, device=dev).scene.has_image_tex,
                "the image texture loads")
        out = _io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["grad-check", scn, "-W", "16"])
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"cli grad-check: {line}")
        got = {x["metric"]: x for x in map(json.loads, lines[1:])}
        require(list(got) == [f"grad_rel_err_{n}"
                              for n in gradcheck.ALL_CHECKS], list(got))
        require(not any("error" in x for x in got.values()), "no errors")
        for name in ("light_col", "texture_col", "roughness", "ior"):
            require(got[f"grad_rel_err_{name}"]["pass"], name)


def bench_phase():
    """``python -m gi_raytracer_tpu_torch.bench`` in a subprocess: exit code
    0 and the five metric lines, finite, from the card, headline last."""
    import math
    with Phase("bench"):
        res = subprocess.run(
            [sys.executable, "-m", "gi_raytracer_tpu_torch.bench",
             "--repeats", str(BENCH_REPEATS)], cwd=HERE, capture_output=True,
            text=True, timeout=BENCH_TIMEOUT)
        for line in res.stdout.splitlines():
            log(f"bench: {line}")
        if res.returncode:
            log(res.stderr[-6000:])
        require(res.returncode == 0, ("bench exit code", res.returncode))
        lines = [json.loads(x) for x in res.stdout.splitlines()]
        require([x["metric"] for x in lines] == BENCH_METRICS,
                [x["metric"] for x in lines])
        for x in lines:
            require(x["backend"] == "torch-cuda" and "error" not in x, x)
            require(math.isfinite(x["value"]) and x["value"] > 0, x)


def _dist_rank(mesh, cfg):
    """One rank of the distribution phase (spawned): the main path's
    photon pass split by slots, its 512x512 render by rows (a warm-up,
    then a timed one), the train step by rays; every launch counted."""
    import torch
    from gi_raytracer_tpu_torch.ops import _cuda
    from gi_raytracer_tpu_torch.parallel.mesh import (render_fused_sharded,
                                                      train_step_sharded)
    from gi_raytracer_tpu_torch.render import Camera, Renderer
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons_sharded)
    from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
    from gi_raytracer_tpu_torch.scene.cornell import (
        CAMERA_LOOK_AT, CAMERA_POS, cornell_box)
    from gi_raytracer_tpu_torch.train import TrainStep

    scene = cornell_box(SceneBuilder, meshgen, full=True).build(
        device=mesh.device)
    cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    _cuda.lib()
    _cuda.reset_launches()
    batch, t_ph = timed(lambda: trace_photons_sharded(scene, cfg, mesh))
    pm = build_photon_map(batch, scene.world_min.cpu().numpy(),
                          scene.world_max.cpu().numpy())
    r = Renderer(scene, cam, cfg, WIDTH, HEIGHT, photon_map=pm)
    render_fused_sharded(r, mesh)
    st, t_r = timed(lambda: render_fused_sharded(r, mesh))
    step = TrainStep(scene, cam, cfg, batch, GRAD_SIZE, GRAD_DEPTH,
                     GRAD_PHOTONS)

    def sgd():
        return train_step_sharded(mesh, step.params(), step.build, step.cfg,
                                  *step.inputs, step.target, lr=DIST_LR)

    sgd()                                       # warm-up
    (loss, new), t_s = timed(sgd)
    torch.cuda.synchronize()
    out = {"launches": {k: _cuda.launches[k] for k in _cuda.KERNELS},
           "plain": {k: _cuda.plain_calls[k] for k in _cuda.KERNELS},
           "seconds": {"photons": t_ph, "render": t_r, "train step": t_s},
           "rays": float(st["rays"]), "blocks": r.wave_blocks,
           "backend": mesh.backend, "device": str(mesh.device),
           "loss": float(loss)}
    if mesh.rank == 0:
        out.update(stored=batch.stored.cpu(), pos=batch.pos.cpu(),
                   col=batch.col.cpu(), mean=st["mean"].cpu(),
                   new={k: v.cpu() for k, v in new.items()})
    return out


def dist_phase(dev, scene, cam, cfg, launches):
    """The main path over DIST_RANKS ranks sharing the card (gloo): each
    rank's K1, K2 and K3 launches counted and added to ``launches``; the
    photon batch, the image and ray count, and the train step held to the
    single process's with ``ray_chunk`` = PHOTONS / DIST_RANKS."""
    import torch
    from gi_raytracer_tpu_torch.parallel.mesh import run_ranks
    from gi_raytracer_tpu_torch.render import Renderer
    from gi_raytracer_tpu_torch.render.photon import (build_photon_map,
                                                      trace_photons)
    from gi_raytracer_tpu_torch.train import TrainStep

    with Phase("distribution: two ranks on the card"):
        outs = run_ranks(_dist_rank, DIST_RANKS, cfg, device="cuda",
                         timeout=DIST_TIMEOUT)
        for rank, o in enumerate(outs):
            secs = {k: round(v, 4) for k, v in o["seconds"].items()}
            log(f"rank {rank} of {DIST_RANKS} on {o['device']} over "
                f"{o['backend']}: seconds {json.dumps(secs)}; render rays {o['rays']:.0f}; kernel launches "
                f"{o['launches']} plain-version calls {o['plain']}")
            require(o["backend"] == "gloo", o["backend"])
            for k in ("megakernel", "intersect", "knn"):
                require(o["launches"][k] > 0, (rank, k, o["launches"]))
            require(o["launches"]["stream"] == 0, (rank, o["launches"]))
            require(not any(o["plain"].values()), (rank, o["plain"]))
            for k in launches:
                launches[k] += o["launches"][k]
        o = outs[0]
    with Phase("distribution: the single process"):
        one_cfg = cfg.replace(ray_chunk=PHOTONS // DIST_RANKS)
        batch, t_ph = timed(lambda: trace_photons(scene, one_cfg))
        stored = batch.stored.cpu()
        require(torch.equal(o["stored"], stored), "stored masks equal")
        pos_ok = torch.allclose(o["pos"][stored], batch.pos.cpu()[stored],
                                rtol=DIST_POS_RTOL, atol=0)
        col_ok = torch.allclose(o["col"][stored], batch.col.cpu()[stored],
                                rtol=DIST_POS_RTOL, atol=0)
        pm = build_photon_map(batch, scene.world_min.cpu().numpy(),
                              scene.world_max.cpu().numpy())
        r = Renderer(scene, cam, cfg, WIDTH, HEIGHT, photon_map=pm)
        r.render()
        (img, st), t_r = timed(lambda: r.render(return_state=True))
        err = (o["mean"] - img.cpu()).abs().max().item()
        step = TrainStep(scene, cam, cfg, batch, GRAD_SIZE, GRAD_DEPTH,
                         GRAD_PHOTONS)
        step.sgd(DIST_LR)                       # warm-up
        (loss, new), t_s = timed(lambda: step.sgd(DIST_LR))
        rel_loss = abs(o["loss"] - loss.item()) / abs(loss.item())
        # relative L2 a parameter: a photon colour the step takes to about
        # zero has no relative error of its own (and the gradients' sums
        # are atomics, in no fixed order, in one process too)
        rel = {k: ((o["new"][k] - v.cpu()).norm() / v.cpu().norm()).item()
               for k, v in new.items()}
        log(f"single process: photons {int(stored.sum())} stored in "
            f"{t_ph:.3f} s, render {float(st['rays']):.0f} rays in "
            f"{t_r:.4f} s, train step {t_s:.4f} s; sharded against it: "
            f"stored equal, positions {'equal' if pos_ok else 'DIFFER'} "
            f"(rtol {DIST_POS_RTOL}), colours "
            f"{'equal' if col_ok else 'DIFFER'}; image max abs err "
            f"{err:.3e}, rays {o['rays']:.0f}; loss rel err {rel_loss:.3e}, "
            f"parameters rel L2 err {json.dumps(rel)}")
        require(pos_ok and col_ok, "photon positions and colours")
        require(err < DIST_IMG_ATOL, ("image", err))
        require(o["rays"] == float(st["rays"]), (o["rays"], st["rays"]))
        require(rel_loss <= DIST_STEP_RTOL, ("loss", rel_loss))
        require(max(rel.values()) <= DIST_STEP_RTOL, ("parameters", rel))
        require(torch.isfinite(img).all(), "finite image")


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    if argv and (len(argv) != 2 or argv[0] not in ("--cornell", "--glass")):
        print("usage: chip_smoke.py [--cornell TREE | --glass TREE]",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[1]) if argv else HERE
    sys.path.insert(0, tree)

    import gi_raytracer_tpu_torch as port
    pkg_dir = os.path.join(tree, "gi_raytracer_tpu_torch")
    if os.path.dirname(os.path.abspath(port.__file__)) != pkg_dir:
        print(f"chip_smoke: no checkout of the repository at {tree}",
              file=sys.stderr)
        return 2

    # what the Cornell path needs, which --cornell TREE takes from the tree
    # (and phase B, which --glass TREE takes from it)
    from gi_raytracer_tpu_torch import routes
    from gi_raytracer_tpu_torch.config import RenderConfig
    from gi_raytracer_tpu_torch.ops import _cuda
    from gi_raytracer_tpu_torch.ops.cuda_megakernel import radiance_wave_mega
    from gi_raytracer_tpu_torch.render import Camera, Renderer
    from gi_raytracer_tpu_torch.scene import SceneBuilder, meshgen
    from gi_raytracer_tpu_torch.scene.cornell import (
        CAMERA_LOOK_AT, CAMERA_POS, FULL_TRIS, cornell_box)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    os.makedirs(OUT_DIR, exist_ok=True)

    # ---- 1. device ------------------------------------------------------
    with Phase("device"):
        smi = nvidia_smi_line()
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()} package {port.__file__}")

    # ---- 2. build -------------------------------------------------------
    with Phase("build"):
        secs = _cuda.build(verbose=True)
        log(f"nvcc build seconds {secs:.3f}")
        _cuda.lib()

    cfg = RenderConfig(min_samples=SPP, max_samples=SPP, adaptive=False,
                       max_depth=DEPTH, photons=PHOTONS, knn_k=KNN_K,
                       seed=SEED)
    cam = Camera(pos=CAMERA_POS, look_at=CAMERA_LOOK_AT)
    scene = cornell_box(SceneBuilder, meshgen, full=True).build(device=dev)
    require(scene.n_tris == FULL_TRIS, scene.n_tris)
    require(routes.wave(scene, cfg) == ("k1", []), routes.wave(scene, cfg))

    if argv and argv[0] == "--glass":
        glass_alone(cam)
        log(nvidia_smi_line())
        return 0
    if argv:
        # --cornell TREE: the Cornell path alone, and K1 at its shape
        with Phase("K1 wave"):
            _, n_closest, ms = k1_wave(scene, cfg, cam)
            log(f"K1 wave without the map: {WIDTH}x{HEIGHT} ({n_closest} "
                f"closest-hit rays) ms {ms:.3f}")
        with Phase("Cornell path"):
            pm, _ = cornell_path(scene, cfg, cam)
        with Phase("K3"):
            from gi_raytracer_tpu_torch.render import photon_knn
            n, host_ms, secs = k3_host_in_render(scene, cfg, cam, pm)
            log(f"K3 inside one render with the map: {n} calls, host ms "
                f"in them {host_ms:.3f} ({host_ms / n * 1e3:.1f} us a "
                f"call), render seconds {secs:.3f}")
            for label, (pts, dirs) in (
                    ("primary hits", k3_queries(scene, cfg, cam)),
                    ("wave 0 caustic queries",
                     k3_wave_queries(scene, cfg, cam, pm)),
                    ("bench points", k3_bench_points(scene, cfg, cam))):
                def call():
                    return photon_knn.sample_photons_tiled(pm, pts, dirs,
                                                           KNN_K)
                ms = cuda_ms(call, 20)
                host_ms = host_issue_ms(call, K3_HOST_CALLS)
                device = k3_device_ms(label, call)
                stats, cand = k3_window_stats(pm, pts)
                log(f"K3 on {pts.shape[0]} {label} with the map: ms "
                    f"{ms:.4f} ({pts.shape[0] * KNN_K / ms / 1e3:.1f} "
                    f"Mphotons/s), host ms to issue a call {host_ms:.4f}, "
                    f"device ms a call {device:.4f}; window cap "
                    f"{json.dumps(stats)}")
                if hasattr(photon_knn, "knn_counts"):   # two tiers
                    k3_tiers(label, pm, pts, dirs, cand)
        log(nvidia_smi_line())
        return 0

    from gi_raytracer_tpu_torch.ops import cuda_intersect as ci
    from gi_raytracer_tpu_torch.ops import cuda_stream as cs
    from gi_raytracer_tpu_torch.ops.cuda_megakernel import mega_info
    from gi_raytracer_tpu_torch.ops.intersect import (
        chunk_boxes, stream_boxes, trace_closest, trace_tables)
    from gi_raytracer_tpu_torch.render import photon as photon_mod
    from gi_raytracer_tpu_torch.render.geom import hemisphere_cos, normalize
    from gi_raytracer_tpu_torch.render.integrator import (dispatch_wave,
                                                          radiance_wave)
    from gi_raytracer_tpu_torch.render.photon import (
        PhotonBatch, build_photon_map, sample_photons_backend, trace_photons)
    from gi_raytracer_tpu_torch.render.photon_knn import (
        knn_info, sample_photons_plain, sample_photons_tiled)
    from gi_raytracer_tpu_torch.sampling.halton import HaltonSampler
    from gi_raytracer_tpu_torch.scene import terrain
    from gi_raytracer_tpu_torch.scene.cornell import (
        ANALYTIC_TRIS, GLASS_SUBDIVS, GLASS_TRIS)

    rows = {}       # kernel name -> its JSON row
    launches = {k: 0 for k in _cuda.KERNELS}   # summed over the main paths

    def drive(name, fn, need, absent):
        """Run one main path with every count set to 0 just before it and
        read just after: the kernels ``need`` must have launched, those in
        ``absent`` must not, and no plain version may have run."""
        # every path starts from a collected heap and an empty allocator
        # cache, whatever the comparisons before it left behind
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        _cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        got = {k: _cuda.launches[k] for k in _cuda.KERNELS}
        plain = {k: _cuda.plain_calls[k] for k in _cuda.KERNELS}
        log(f"{name}: kernel launches {got} plain-version calls {plain}")
        for k in need:
            require(got[k] > 0, (name, k, got))
        for k in absent:
            require(got[k] == 0, (name, k, got))
        for k in _cuda.KERNELS:
            require(plain[k] == 0, (name, k, plain))
            launches[k] += got[k]
        return out

    def rays_for(n_rays):
        return (torch.full((n_rays,), ci.BIG, device=dev),
                torch.ones(n_rays, dtype=torch.bool, device=dev),
                torch.arange(n_rays, device=dev, dtype=torch.int32))

    def walk_bound(active, visits, tests, n_groups, n_tab, n_boxes):
        """(ms, by, active ray-visits) of one walk (K2 or K4) from what it
        needed: the ray-triangle tests it made, the cull (every active ray
        into every group box) and each active ray's own entry into each
        group its tile visited; the rays, the ``n_tab``-row table and the
        ``n_boxes`` boxes read once, the answers written once.  The chunk
        boxes K4 tests inside a visited superchunk are left out (the
        kernel does not count them), so the bound is a floor."""
        R = active.shape[0]
        n_act = torch.nn.functional.pad(
            active.int(), (0, visits.numel() * ci.RAY_TILE - R)) \
            .view(-1, ci.RAY_TILE).sum(1)
        ray_visits = int((visits.long() * n_act).sum())
        n_active = int(active.sum())
        ms, by = bound(int(tests.long().sum()) * OPS_PER_TEST
                       + (n_active * n_groups + ray_visits) * OPS_PER_SLAB,
                       R * (12 + 12 + 4 + 1 + 4 + 8) + n_tab * (64 + 4)
                       + n_boxes * 32)
        return ms, by, ray_visits

    class Staged(photon_mod.ThreefryUniform):
        """The default source's draws under another type, which the round
        kernel leaves to the staged round."""

    def photon_round(scn, c):
        """The traces of one round of the photon pass of ``scn``: one
        chunk of ``c.ray_chunk`` slots, one round (the emission trace and
        ``c.photon_depth`` continuation traces), as (ro, rd, active, ray
        id, salt) per trace: the staged round's."""
        calls = []
        orig = photon_mod.trace_closest

        def record(scene_, ro, rd, t_max=None, salt=0, eps=1e-5,
                   active=None, ray_id=None, plain=False):
            calls.append((ro.float().contiguous(), rd.float().contiguous(),
                          active.clone(), ray_id.clone(), salt))
            return orig(scene_, ro, rd, t_max, salt, eps, active, ray_id,
                        plain)
        photon_mod.trace_closest = record
        try:
            trace_photons(scn, c.replace(photons=c.ray_chunk,
                                         photon_retries=1),
                          uniform=Staged(c.seed, scn.device))
        finally:
            photon_mod.trace_closest = orig
        return calls

    def walk_round(name, query, scn, boxes, calls, eps):
        """Time the walk ``query`` (K2 or K4) on each trace of a photon
        round; logs the ms, bound ms and tests summed over the round and
        returns the bound ms with what binds each trace."""
        feat_, acc_ = trace_tables(scn)
        ms = b_ms = 0.0
        tests_all = 0
        bys = set()
        for ro, rd, act, rid, salt in calls:
            R = ro.shape[0]
            a = (feat_, acc_, *boxes, ro, rd, rays_for(R)[0], act, rid, salt,
                 eps, False, scn.all_opaque)
            _, _, v, n_t = query(*a, return_counts=True)
            ms += cuda_ms(lambda: query(*a), 3)
            b, by, _ = walk_bound(act, v, n_t, boxes[0].shape[1],
                                  feat_.shape[0], sum(b_.shape[1]
                                                      for b_ in boxes))
            b_ms += b
            bys.add(by)
            tests_all += int(n_t.long().sum())
        log(f"{name}: {len(calls)} traces of {calls[0][0].shape[0]} slots, "
            f"active rays {[int(c_[2].sum()) for c_ in calls]}; ms {ms:.3f} "
            f"tests made {tests_all} bound ms {b_ms:.4f}")
        return b_ms, "/".join(sorted(bys))

    def round_kernel_ms(scn, c, walks):
        """The round kernel's row: CUDA-event ms on round 0 of one chunk of
        ``c.ray_chunk`` slots (every slot live; the chunk's arrays zeroed
        before each timed launch), the staged round's wall ms on the same
        round, and the largest difference of their batches, which must be
        equal: the timed launches' against the staged round 0 of the same
        slots, and ``trace_photons``'s one round on each route.  ``walks``
        (bound ms, what binds) is the floor of the staged round's six K2
        traces (``walk_round``), which the kernel walks too: its bound
        leaves the shading, draws and store out.  Logs the whole chunk's
        pass too."""
        from gi_raytracer_tpu_torch.ops import cuda_photon
        n = c.ray_chunk
        light = photon_mod._light_row(scn, 0, n)
        keys = photon_mod.ThreefryUniform(c.seed, scn.device).round_keys(
            0, 0, c.photon_retries, c.photon_depth)
        pos = torch.zeros((n, 3), device=dev)
        dirs, col = torch.zeros_like(pos), torch.zeros_like(pos)
        stored = torch.zeros(n, dtype=torch.bool, device=dev)
        count = torch.zeros(1, dtype=torch.int32, device=dev)
        launch = cuda_photon.round_launcher(
            scn, light, keys, pos, dirs, col, stored, count, 0, c.epsilon,
            c.shadow_bias, HaltonSampler().arith_plan(3))
        info = cuda_photon.round_info(scn)
        ms = []
        for rep in range(6):
            for t in (pos, dirs, col, stored, count):
                t.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(0, photon_mod._round_salt(0, 0))
            end.record()
            torch.cuda.synchronize()
            if rep:             # the first launch warms up
                ms.append(start.elapsed_time(end))
        slot = torch.arange(n, device=dev)
        want = photon_mod._emit_attempts(
            scn, c, HaltonSampler(), 0, (slot * c.photon_retries) & 0xFFFFFFFF,
            photon_mod.ThreefryUniform(c.seed, scn.device), 0, 0,
            torch.ones(n, dtype=torch.bool, device=dev), slot, n)
        require(torch.equal(stored, want.stored), "the timed round's stored "
                "mask equals the staged round 0's")
        err = max(float((got - getattr(want, f)).abs().max())
                  for got, f in ((pos, "pos"), (dirs, "dir"), (col, "col")))
        chunk_s = timed(lambda: photon_mod.trace_photons(
            scn, c.replace(photons=n)))[1]
        one = c.replace(photons=n, photon_retries=1)
        require(routes.photon_round(
            scn, one, None, Staged(c.seed, scn.device), False) == (
                "staged",
                ["emission uniforms from Staged, not ThreefryUniform"]),
                "Staged takes the staged round")
        fast = photon_mod.trace_photons(scn, one)
        staged, plain_s = timed(lambda: photon_mod.trace_photons(
            scn, one, uniform=Staged(c.seed, scn.device)))
        require(torch.equal(fast.stored, staged.stored),
                "the round kernel's stored mask equals the staged round's")
        err = max([err] + [float((getattr(fast, f) - getattr(staged, f))
                                 .abs().max()) for f in ("pos", "dir", "col")])
        log(f"round kernel {json.dumps(info)}: round 0 of {n} slots "
            f"{sum(ms) / len(ms):.3f} ms (CUDA events, {len(ms)} launches), "
            f"staged round {plain_s * 1e3:.1f} ms, largest difference "
            f"{err:.3e}; the chunk's whole pass {chunk_s:.4f} s")
        require(err == 0, ("the round kernel's photons equal the staged "
                           "round's", err))
        require(info["blocks_per_sm"] >= 1 and info["local_bytes"] <= 64,
                info)
        return dict(name="photon_round", route="cuda",
                    source="gi_raytracer_tpu_torch/csrc/photon.cu",
                    replaces=None, max_abs_err=err, ms=sum(ms) / len(ms),
                    plain_ms=plain_s * 1e3, bound_ms=walks[0],
                    bound_by=f"{walks[1]} of the walks alone",
                    library_ms=None)

    def walk_resources(kernel, n_groups):
        info = ci.walk_info(kernel, n_groups)
        log(f"{kernel} kernel at {n_groups} groups: {json.dumps(info)}")
        require(info["blocks_per_sm"] >= 1, (kernel, info))

    # ---- 3. the Cornell main path, timed before the comparisons ---------
    with Phase("main path"):
        pm, cornell_batch = drive(
            "Cornell main path", lambda: cornell_path(scene, cfg, cam),
            need=("photon_round", "megakernel", "knn", "wave_inputs"),
            absent=("stream", "intersect"))
    profile("Cornell render with the map",
            Renderer(scene, cam, cfg, WIDTH, HEIGHT, photon_map=pm).render)
    # the profiles trace one chunk of a pass (its busy share is the
    # pass's: every chunk runs the same rounds); a whole 750k pass under
    # the profiler took 97 s once its draws became threefry's
    with Phase("Cornell photon pass profile"):
        profile("Cornell photon pass, one chunk",
                lambda: trace_photons(scene, cfg.replace(
                    photons=cfg.ray_chunk)), host=False)

    # ---- 4. kernels against their plain versions ------------------------
    with Phase("K2 intersect vs plain"):
        feat, accept = trace_tables(scene)
        cbox = chunk_boxes(scene)
        walk_resources("intersect", cbox.shape[1])
        ro_p, rd_p, _, _ = Renderer(scene, cam, cfg, WIDTH, HEIGHT) \
            .wave_inputs(0)
        n = ro_p.shape[0]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ro_r = (torch.rand((n, 3), generator=gen, device=dev) * 2 - 1) * 3.9
        rd_r = normalize(torch.randn((n, 3), generator=gen, device=dev))
        ro = torch.cat([ro_p, ro_r]).contiguous()
        rd = torch.cat([rd_p, rd_r]).contiguous()
        R = ro.shape[0]
        args = (ro, rd, *rays_for(R), 0, cfg.epsilon)
        # the kernel orders hits by an approximate t (a bfloat16-rounded
        # reciprocal); the exact t of the winner is recomputed after it,
        # and that is the t the gate holds to rtol 1e-5
        ta_k, p_k, v_k, n_k = ci.prim_query(
            feat, accept, cbox, *args, False, scene.all_opaque,
            return_counts=True)
        ta_p, p_p, v_p, n_p = ci.prim_query_plain(
            feat, accept, cbox, *args, False, scene.all_opaque,
            return_counts=True)
        _, p_b = ci.prim_query_brute(feat, accept, *args, False,
                                     scene.all_opaque)
        hit_k = trace_closest(scene, ro, rd)
        hit_p = trace_closest(scene, ro, rd, plain=True)
        require(torch.equal(hit_k.prim >= 0, p_k >= 0),
                "K2 hit mask of trace_closest and prim_query")
        frac_same = (hit_k.prim == hit_p.prim).float().mean().item()
        mask_same = ((hit_k.prim >= 0) == (hit_p.prim >= 0)).float() \
            .mean().item()
        both = (hit_k.prim >= 0) & (hit_p.prim >= 0)
        t_err = (hit_k.t - hit_p.t).abs()[both]
        t_rel = (t_err / hit_p.t[both].abs()).max().item()
        same = (p_k == p_p) & (p_p >= 0)
        ta_rel = ((ta_k - ta_p).abs() / ta_p.abs())[same].max().item()
        tests_k, tests_p = int(n_k.long().sum()), int(n_p.long().sum())
        _, a_k, _, an_k = ci.prim_query(feat, accept, cbox, *args, True,
                                        scene.all_opaque, return_counts=True)
        _, a_p, _, an_p = ci.prim_query_plain(
            feat, accept, cbox, *args, True, scene.all_opaque,
            return_counts=True)
        _, a_b = ci.prim_query_brute(feat, accept, *args, True,
                                     scene.all_opaque)
        any_same = ((a_k >= 0) == (a_p >= 0)).float().mean().item()
        any_brute = ((a_k >= 0) == (a_b >= 0)).float().mean().item()
        ms = cuda_ms(lambda: ci.prim_query(feat, accept, cbox, *args, False,
                                           scene.all_opaque), 5)
        plain_ms = cuda_ms(lambda: ci.prim_query_plain(
            feat, accept, cbox, *args, False, scene.all_opaque), 1)
        brute_ms = cuda_ms(lambda: ci.prim_query_brute(
            feat, accept, *args, False, scene.all_opaque), 1)
        log(f"K2 rays {R} hits {both.float().mean().item():.4f} "
            f"prim equal {frac_same:.6f} hit mask equal {mask_same:.6f} "
            f"exact t max rel err {t_rel:.3e} (approximate t {ta_rel:.3e}) "
            f"any-hit mask equal {any_same:.6f} (brute force "
            f"{any_brute:.6f}); visits per tile mean "
            f"{v_k.float().mean().item():.2f} max {v_k.max().item()} of "
            f"{cbox.shape[1]}, tiles with the plain walk's visits "
            f"{(v_k == v_p).float().mean().item():.4f}, tests "
            f"{(n_k == n_p).float().mean().item():.4f}; tests made {tests_k} "
            f"(plain walk {tests_p}; brute force {R * feat.shape[0]}); any "
            f"hit tests {int(an_k.long().sum())} (plain walk "
            f"{int(an_p.long().sum())})")
        require(frac_same >= K2_PRIM_EQUAL, frac_same)
        require(mask_same >= K2_PRIM_EQUAL, mask_same)
        require(t_rel <= K2_T_RTOL, t_rel)
        require(any_same >= K2_PRIM_EQUAL, any_same)
        require(any_brute >= K2_PRIM_EQUAL, any_brute)
        require(abs(tests_k - tests_p) <= K4_TESTS_RTOL * tests_p,
                ("K2 tests made", tests_k, tests_p))
        hit_gates("K2 closest hit against the brute force", scene, ro, rd,
                  p_k, p_b, cfg.epsilon)
        Tp = feat.shape[0]
        b_ms, b_by, _ = walk_bound(args[3], v_k, n_k, cbox.shape[1], Tp,
                                   cbox.shape[1])
        log(f"K2 closest-hit ms {ms:.3f} plain ms {plain_ms:.3f} brute "
            f"force ms {brute_ms:.3f} bound ms {b_ms:.4f} ({b_by})")
        walks = walk_round("K2 Cornell photon round", ci.prim_query, scene,
                           (cbox,), photon_round(scene, cfg), cfg.epsilon)
        rows["photon_round"] = round_kernel_ms(scene, cfg, walks)
        rows["intersect"] = dict(
            name="intersect", route="cuda",
            source="gi_raytracer_tpu_torch/csrc/intersect.cu",
            replaces="gi_raytracer_tpu/ops/pallas_intersect.py:108",
            max_abs_err=t_err.max().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del ro, rd, ro_r, rd_r, args, hit_k, hit_p

    # K1 and K3 are held against their plain versions with the main path's
    # photon map
    def k1_gate(name, scn, wave, prim_rows, pmap):
        """K1 against the plain staged wave on ``wave`` (lanes off, ray
        counts); returns the largest difference and the plain wave's ms.
        At 512x512 the wave has about four lanes a resident thread, so the
        kernel's lane queue refills ended paths and warps mix depths."""
        ro, rd, sx, sy, lane = wave
        R = ro.shape[0]
        got, (kc, ks) = dispatch_wave(scn, cfg, ro, rd, sx, sy, 0, pmap,
                                      lane_ids=lane, route="k1")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want, (wc, ws) = radiance_wave(scn, cfg, ro, rd, sx, sy, 0, pmap,
                                       lane_ids=lane, prim_rows=prim_rows,
                                       plain=True)
        end.record()
        torch.cuda.synchronize()
        err = (got - want).abs().max(-1).values
        off = (err > K1_LANE_TOL).float().mean().item()
        kc, ks, wc, ws = int(kc), int(ks), int(wc), int(ws)
        log(f"{name}: lanes {R} off>{K1_LANE_TOL} {off:.6f} max abs err "
            f"{err.max().item():.3e} closest {kc}/{wc} shadow {ks}/{ws} "
            f"finite {bool(torch.isfinite(got).all())}; plain ms "
            f"{start.elapsed_time(end):.3f}")
        require(torch.isfinite(got).all(), f"{name}: finite")
        require(off < K1_MAX_OFF, (name, off))
        require(abs(kc - wc) <= K1_COUNT_RTOL * wc, (name, kc, wc))
        require(abs(ks - ws) <= K1_COUNT_RTOL * ws, (name, ks, ws))
        return err.max().item(), start.elapsed_time(end)

    def k1_tests(scn, wave):
        """The ray-triangle tests (closest, shadow) K1 makes on ``wave``
        without the map."""
        tests = torch.zeros(2, dtype=torch.int64, device=dev)
        radiance_wave_mega(scn, cfg, *wave, 0, None, tests=tests)
        return tests.tolist()

    with Phase("K1 megakernel vs plain"):
        glass8k = cornell_box(SceneBuilder, meshgen, True,
                              K1_GLASS_SUBDIVS).build(device=dev)
        require(glass8k.n_tris == K1_GLASS_TRIS, glass8k.n_tris)
        require(routes.wave(glass8k, cfg) == ("k1", []),
                routes.wave(glass8k, cfg))
        for scn in (scene, glass8k):
            info = mega_info(scn)
            log(f"K1 resources, {scn.n_tris} triangles: {json.dumps(info)}")
            require(info["blocks_per_sm"] >= 1, info)
            require(info["table_in_smem"] == (scn is scene),
                    ("the Cornell table in shared memory, the glass box's "
                     "not", info))
        batch8k = trace_photons(glass8k, cfg.replace(
            photons=K1_GLASS_PHOTONS))
        gpm8k = build_photon_map(batch8k, glass8k.world_min.cpu().numpy(),
                                 glass8k.world_max.cpu().numpy())
        wave, gc512, ms = k1_wave(scene, cfg, cam)
        R = wave[0].shape[0]
        tests = k1_tests(scene, wave)
        glass_r = Renderer(glass8k, cam, cfg, WIDTH, HEIGHT)
        glass_wave = glass_r.wave_inputs(0) + (wave[4],)
        glass_ms = cuda_ms(lambda: radiance_wave_mega(
            glass8k, cfg, *glass_wave, 0, None), 5)
        log(f"K1 glass {glass8k.n_tris} {WIDTH}x{HEIGHT} ms {glass_ms:.3f} "
            f"tests {k1_tests(glass8k, glass_wave)}")
        errs, plain = {}, {}
        for scn, label, w, prim_rows, maps in (
                (scene, "Cornell", wave,
                 Renderer(scene, cam, cfg, WIDTH, HEIGHT).prim_rows(),
                 (None, pm)),
                (glass8k, f"glass {glass8k.n_tris}", glass_wave,
                 glass_r.prim_rows(), (None, gpm8k))):
            for pmap in maps:
                name = (f"K1 {label} {WIDTH}x{HEIGHT} "
                        f"{'map' if pmap else 'no map'}")
                errs[name], plain[name] = k1_gate(name, scn, w, prim_rows,
                                                  pmap)
        plain_ms = plain[f"K1 Cornell {WIDTH}x{HEIGHT} no map"]
        del batch8k, gpm8k, glass8k, glass_r, glass_wave
        # the bound from the tests the closest and shadow walks made (the
        # box tests, shading and the rest add to them); beside it the
        # brute force's, every closest-hit ray against every row
        nbytes = R * (24 + 4 + 32) + DEPTH * R * 8 + Tp * (256 + 64)
        b_ms, b_by = bound(sum(tests) * OPS_PER_TEST, nbytes)
        brute_ms, _ = bound(gc512 * Tp * OPS_PER_TEST, nbytes)
        log(f"K1 wave without the map: {WIDTH}x{HEIGHT} ({R} lanes, "
            f"{gc512} closest-hit rays) ms {ms:.3f} plain ms {plain_ms:.3f}; "
            f"ray-triangle tests made closest {tests[0]} shadow {tests[1]} "
            f"(brute force closest {gc512 * Tp}); bound ms {b_ms:.4f} "
            f"({b_by}; brute force {brute_ms:.3f})")
        rows["megakernel"] = dict(
            name="megakernel", route="cuda",
            source="gi_raytracer_tpu_torch/csrc/megakernel.cu",
            replaces="gi_raytracer_tpu/ops/pallas_megakernel.py:344",
            max_abs_err=errs[f"K1 Cornell {WIDTH}x{HEIGHT} map"], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del wave

    with Phase("wave inputs"):
        rows["wave_inputs"] = wave_inputs_row(scene, cam)

    def knn_cost(pmap, pts):
        """(FP32 operations, bytes, byte parts, candidates a query, window
        stats) of a kNN estimate: d^2 of every candidate of the whole
        window; the bytes of ``k3_bytes``."""
        stats, cand = k3_window_stats(pmap, pts)
        nbytes, parts = k3_bytes(pmap, pts, KNN_K)
        return (int(cand.sum()) * OPS_PER_CANDIDATE, nbytes, parts, cand,
                stats)

    with Phase("K3 knn vs plain"):
        # two query sets on the Cornell map: the 65,536 primary hits of the
        # earlier records, and the caustic queries K3 answers in wave 0 of
        # the render with the map (the main path's shape, the row's)
        sets = {"primary hits": k3_queries(scene, cfg, cam),
                "wave 0 caustic queries": k3_wave_queries(scene, cfg, cam,
                                                          pm)}
        for label, (pts, dirs) in sets.items():
            got = sample_photons_tiled(pm, pts, dirs, KNN_K)
            want = sample_photons_plain(pm, pts, dirs, KNN_K)
            err = (got - want).abs()
            close = (err <= K3_ATOL + K3_RTOL * want.abs()).all(-1)
            frac = close.float().mean().item()
            k3_tiers(label, pm, pts, dirs, k3_window_stats(pm, pts)[1],
                     got, want)
            nonzero = (want.abs().sum(-1) > 0).float().mean().item()
            ms = cuda_ms(lambda: sample_photons_tiled(pm, pts, dirs, KNN_K),
                         20)
            plain_ms = cuda_ms(
                lambda: sample_photons_plain(pm, pts, dirs, KNN_K), 1)
            ops, nbytes, parts, cand, stats = knn_cost(pm, pts)
            b_ms, b_by = bound(ops, nbytes)
            capped = sample_photons_backend(pm, pts, dirs, KNN_K, "jnp")
            log(f"K3 {label}: window cap {json.dumps(stats)}")
            log(f"K3 {label}: queries {pts.shape[0]} nonzero {nonzero:.4f} "
                f"close {frac:.6f} max abs err {err.max().item():.3e}")
            log(f"K3 {label}: ms {ms:.4f} plain ms {plain_ms:.3f} bound ms "
                f"{b_ms:.4f} ({b_by}; bytes {nbytes} from "
                f"{json.dumps(parts)}); window candidates mean "
                f"{cand.float().mean().item():.2f}")
            log(f"K3 {label}: caustic energy (sum of the estimates) whole "
                f"window {got.sum().item():.6e}, capped estimator "
                f"(knn_backend jnp) {capped.sum().item():.6e}")
            require(frac >= K3_CLOSE, (label, frac))
            require(nonzero > 0.0, (label, nonzero))
            # each tier's device time (the focal launch on an empty queue
            # on the primary hits)
            k3_device_ms(label, lambda: sample_photons_tiled(
                pm, pts, dirs, KNN_K))
            del got, want, capped
        info = knn_info()
        log(f"K3 resources {json.dumps(info)}")
        require(info["warp"]["local_bytes"] == 0
                and info["focal"]["local_bytes"] == 0, info)
        del sets, pts, dirs
        # the Cornell render's caustic energy (with the map less without
        # it: the map adds to the paths and changes none of them), whole
        # window against the capped estimator; logged, not gated
        energy = {}
        for label, c, pmap in (("without map", cfg, None),
                               ("whole window", cfg, pm),
                               ("capped (jnp)",
                                cfg.replace(knn_backend="jnp"), pm)):
            img = Renderer(scene, cam, c, WIDTH, HEIGHT,
                           photon_map=pmap).render()
            energy[label] = img.double().sum().item()
        base = energy.pop("without map")
        log("Cornell render caustic energy (image sum with the map less "
            "without it): " + ", ".join(
                f"{k} {v - base:.6e}" for k, v in energy.items())
            + f"; image sum without the map {base:.6e}")
        rows["knn"] = dict(
            name="knn", route="cuda",
            source="gi_raytracer_tpu_torch/csrc/knn.cu",
            replaces="gi_raytracer_tpu/render/photon_knn.py:652,696,71",
            max_abs_err=err.max().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None)

    # ---- K1 on block-compacted waves: the mesh Cornell box, adaptive ----
    a_cfg = cfg.replace(min_samples=ADAPT_MIN, max_samples=ADAPT_MAX,
                        noise_thresh=ADAPT_THRESH, adaptive=True)

    def adaptive_render(scn, c, pmap, compaction):
        r = Renderer(scn, cam, c, WIDTH, HEIGHT, photon_map=pmap,
                     block_compaction=compaction)
        (img, st), secs = timed(lambda: r.render(return_state=True))
        return r, img, st, secs

    with Phase("K1 block-adaptive"):
        for pmap in (None, pm):
            label = "map" if pmap is not None else "no map"
            r, img, st, secs = drive(
                f"K1 block-adaptive Cornell {label}",
                lambda: adaptive_render(scene, a_cfg, pmap, True),
                need=("megakernel", "wave_inputs")
                + (("knn",) if pmap is not None else ()),
                absent=("stream", "intersect"))
            _, img_f, st_f, secs_f = adaptive_render(scene, a_cfg, pmap,
                                                     False)
            off = ((img - img_f).abs().max(-1).values > K1_LANE_TOL) \
                .float().mean().item()
            log(f"K1 block-adaptive Cornell {WIDTH}x{HEIGHT} "
                f"{ADAPT_MIN}-{ADAPT_MAX} spp {label}: waves {st['wave']}, "
                f"blocks per wave {r.wave_blocks}; rays compacted "
                f"{float(st['rays']):.0f} in {secs:.3f} s, full frame "
                f"{float(st_f['rays']):.0f} in {secs_f:.3f} s; pixels off "
                f">{K1_LANE_TOL} {off:.6f}")
            require(torch.isfinite(img).all(), "finite adaptive image")
            require(off < K1_MAX_OFF, ("K1 block-adaptive", label, off))
            require(torch.equal(st["samps"], st_f["samps"]), "samps equal")
            require(torch.equal(st["active"], st_f["active"]), "active equal")
            require(st["wave"] == st_f["wave"], (st["wave"], st_f["wave"]))
            require(blocks_never_grow(r.wave_blocks), r.wave_blocks)
            require(float(st["rays"]) < float(st_f["rays"]), "fewer rays")
    del pm

    with Phase("K3 knn vs plain, dense focus"):
        # a dense core in a sparse background, about 90 photons a core
        # cell: windows from a few to ~2,400 candidates, every tier of
        # photon_knn.py:71 _knn_kernel; and a near-coincident focus that
        # no grid splits, as at a caustic focus: the map's densest cell
        # holds more than its window cap (96) and the focus's windows
        # hold thousands of candidates
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        focus_at = torch.tensor([0.1, 0.05, -0.1], device=dev)
        # a second focus past a focal block's shared memory
        spill_at = torch.tensor([-0.6, 0.7, 0.55], device=dev)
        n_spill = knn_info()["staged_capacity"] + DENSE_SPILL_EXTRA
        pos = torch.cat([
            (torch.rand((DENSE_CORE, 3), generator=g, device=dev) - 0.5) * 0.5,
            (torch.rand((DENSE_BACKGROUND, 3), generator=g, device=dev)
             - 0.5) * 2.0,
            focus_at + DENSE_FOCUS_SIGMA * torch.randn(
                (DENSE_FOCUS, 3), generator=g, device=dev),
            spill_at + DENSE_FOCUS_SIGMA * torch.randn(
                (n_spill, 3), generator=g, device=dev)])
        P = pos.shape[0]
        dmap = build_photon_map(PhotonBatch(
            pos, normalize(torch.randn((P, 3), generator=g, device=dev)),
            torch.rand((P, 3), generator=g, device=dev) * 1e-3,
            torch.ones(P, dtype=torch.bool, device=dev)),
            (-1.0,) * 3, (1.0,) * 3, target_per_cell=1.78,
            max_cells=1 << 20)      # stops at the first grid
        q = torch.cat([
            (torch.rand((DENSE_QUERIES, 3), generator=g, device=dev) - 0.5)
            * 0.7,
            focus_at + 2 * DENSE_FOCUS_SIGMA * torch.randn(
                (DENSE_FOCUS_QUERIES, 3), generator=g, device=dev),
            spill_at + 2 * DENSE_FOCUS_SIGMA * torch.randn(
                (DENSE_SPILL_QUERIES, 3), generator=g, device=dev)])
        qd = normalize(torch.randn((q.shape[0], 3), generator=g,
                                   device=dev))
        got = sample_photons_tiled(dmap, q, qd, KNN_K)
        want = sample_photons_plain(dmap, q, qd, KNN_K)
        stats, cand = k3_window_stats(dmap, q)
        occ = stats["densest_cell"]
        require(occ > dmap.window_cap, (occ, dmap.window_cap))
        dense = cand > K3_DENSE_WINDOW
        close = ((got - want).abs() <= K3_ATOL + K3_RTOL * want.abs()).all(-1)
        tiers = [int(((cand > lo_) & (cand <= hi_)).sum())
                 for lo_, hi_ in ((-1, 128), (128, 512), (512, KNN_BUDGET),
                                  (KNN_BUDGET, 1 << 30))]
        focus_ms = cuda_ms(lambda: sample_photons_tiled(dmap, q, qd, KNN_K), 5)
        log(f"K3 dense focus: window cap {json.dumps(stats)}; K3 ms "
            f"{focus_ms:.4f}")
        log(f"K3 dense focus: map dims {dmap.dims} densest cell {occ} "
            f"window_cap {dmap.window_cap}; queries {q.shape[0]}, windows "
            f"<=128 / <=512 / <=2048 / more: {tiers}; close "
            f"{close.float().mean().item():.6f}, on windows past "
            f"{K3_DENSE_WINDOW} {close[dense].float().mean().item():.6f} "
            f"({int(dense.sum())} queries)")
        require(min(tiers) > 0, tiers)
        counts = k3_tiers("dense focus", dmap, q, qd, cand, got, want)
        require(min(counts.values()) > 0, ("every K3 tier", counts))
        require(close[dense].float().mean().item() >= K3_CLOSE, "dense K3")
        require(close.float().mean().item() >= K3_CLOSE, "K3 dense focus")
        del dmap, pos, q, qd, got, want

    # ---- 5. the big-scene path: K4 and phase A ---------------------------
    big_cfg = RenderConfig(min_samples=BIG_SPP, max_samples=BIG_SPP,
                           adaptive=False, max_depth=BIG_DEPTH, photons=0,
                           seed=SEED)
    big_cam = Camera(pos=terrain.CAMERA_POS, look_at=terrain.CAMERA_LOOK_AT)

    def terrain_build(n):
        b, t_pop = timed(lambda: terrain.terrain_scene(SceneBuilder, n))
        big, t_build = timed(lambda: b.build(device=dev))
        _, t_tab = timed(lambda: (trace_tables(big), stream_boxes(big),
                                  chunk_boxes(big)))
        require(big.n_tris == terrain.terrain_tris(n), big.n_tris)
        require(routes.trace(big)[0] == "k4", "the terrain goes to K4")
        log(f"terrain {big.n_tris} triangles: mesh {t_pop:.3f} s, scene "
            f"build with the SAH BVH {t_build:.3f} s, trace tables, "
            f"{stream_boxes(big).shape[1]} superchunk and "
            f"{chunk_boxes(big).shape[1]} chunk boxes {t_tab:.3f} s")
        return big

    def k4_gates(big, ro, rd, accept, salt, rid, all_opaque, label):
        """K4 closest and any hit against its plain walk and the brute force
        (the plain walk's per-tile counts too); returns the largest exact-t
        difference."""
        feat_b, scbox, cbox = (trace_tables(big)[0], stream_boxes(big),
                               chunk_boxes(big))
        R = ro.shape[0]
        errs = []
        for any_hit in (False, True):
            name = f"K4 {label} {'any' if any_hit else 'closest'} hit"
            base = (ro, rd, torch.full((R,), ci.BIG, device=dev),
                    torch.ones(R, dtype=torch.bool, device=dev), rid, salt,
                    big_cfg.epsilon, any_hit, all_opaque)
            _, p_k, v_k, n_k = cs.prim_query_stream(
                feat_b, accept, scbox, cbox, *base, return_counts=True)
            _, p_w, v_w, n_w = cs.prim_query_stream_plain(
                feat_b, accept, scbox, cbox, *base, return_counts=True)
            _, p_b = ci.prim_query_brute(feat_b, accept, *base)
            tests_k, tests_w = int(n_k.long().sum()), int(n_w.long().sum())
            log(f"{name}: visits per tile mean "
                f"{v_k.float().mean().item():.2f} max {v_k.max().item()} of "
                f"{scbox.shape[1]}; tests {tests_k} (plain walk {tests_w}); "
                f"tiles with the plain walk's visits "
                f"{(v_k == v_w).float().mean().item():.4f}, tests "
                f"{(n_k == n_w).float().mean().item():.4f}")
            require(abs(tests_k - tests_w) <= K4_TESTS_RTOL * tests_w,
                    (name, "tests made", tests_k, tests_w))
            if any_hit:
                for ref, what in ((p_w, "plain walk"), (p_b, "brute force")):
                    eq = ((p_k >= 0) == (ref >= 0)).float().mean().item()
                    log(f"{name} against the {what}: occluded mask equal "
                        f"{eq:.6f}")
                    require(eq >= K2_PRIM_EQUAL, (name, what, eq))
            else:
                errs.append(hit_gates(f"{name} against the plain walk",
                                      big, ro, rd, p_k, p_w,
                                      big_cfg.epsilon))
                errs.append(hit_gates(f"{name} against the brute force",
                                      big, ro, rd, p_k, p_b,
                                      big_cfg.epsilon))
        return max(errs)

    def k4_wave(big, label, ro, rd, t_lim, active, any_hit, plain):
        """K4 on one set of rays (ray ids 0..R-1, salt 0), its time and the
        bound from the tests it made; with ``plain`` the plain walk's time
        too.  Logs and returns (ms, plain ms or None, bound ms, bound by)."""
        (feat_b, accept_b) = trace_tables(big)
        scbox, cbox = stream_boxes(big), chunk_boxes(big)
        R = ro.shape[0]
        a = (feat_b, accept_b, scbox, cbox, ro, rd, t_lim, active,
             torch.arange(R, device=dev, dtype=torch.int32), 0,
             big_cfg.epsilon, any_hit, big.all_opaque)
        ms = cuda_ms(lambda: cs.prim_query_stream(*a), 5)
        plain_ms = cuda_ms(lambda: cs.prim_query_stream_plain(*a), 1) \
            if plain else None
        # the set-up alone (primary rays, whose origin lies outside every
        # box): with a t limit of 1e-9 no superchunk is entered, so the
        # launch is the cull over every box and nothing after it
        a0 = a[:6] + (torch.full_like(t_lim, 1e-9),) + a[7:]
        setup_ms = cuda_ms(lambda: cs.prim_query_stream(*a0), 5) \
            if plain else float("nan")
        _, p, v, n_t = cs.prim_query_stream(*a, return_counts=True)
        tests = int(n_t.long().sum())
        b_ms, b_by, ray_visits = walk_bound(active, v, n_t, scbox.shape[1],
                                            feat_b.shape[0],
                                            scbox.shape[1] + cbox.shape[1])
        n_act = int(active.sum())
        log(f"K4 terrain {big.n_tris} {label}: rays {R} active {n_act} hit "
            f"{(p >= 0).float().mean().item():.4f}; visits per tile mean "
            f"{v.float().mean().item():.2f} max {v.max().item()} of "
            f"{scbox.shape[1]}, {tests} ray-triangle tests made "
            f"({tests / max(n_act, 1):.1f} per active ray; every active ray "
            f"of a visiting tile in every visited superchunk: "
            f"{ray_visits * cs.SC_TRIS}); K4 ms {ms:.3f} (set-up alone "
            f"{setup_ms:.3f}) plain ms "
            f"{plain_ms if plain_ms is None else round(plain_ms, 3)} bound "
            f"ms {b_ms:.4f} ({b_by})")
        return ms, plain_ms, b_ms, b_by

    def k4_rays(big, n):
        """K4 over one wave's primary rays; on the largest terrain also over
        the diffuse bounce rays from their hits (cosine-weighted about the
        normal, from a seeded generator) and the shadow rays from the hits
        to the light (any hit).  Returns the primary rays' (ms, plain ms,
        bound ms, bound by)."""
        ro_w, rd_w, _, _ = Renderer(big, big_cam, big_cfg, BIG_SIZE,
                                    BIG_SIZE).wave_inputs(0)
        R = ro_w.shape[0]
        t_big, all_on, _ = rays_for(R)
        prim_row = k4_wave(big, "primary wave", ro_w, rd_w, t_big, all_on,
                           False, n == terrain.BIG_N)
        if n != terrain.BIG_N:
            return prim_row
        hit = trace_closest(big, ro_w, rd_w)
        ok = hit.prim >= 0
        tr = big.tris
        pidx = torch.clamp(hit.prim, min=0).long()
        nrm = normalize(torch.linalg.cross(tr.e1[pidx], tr.e2[pidx]))
        nrm = torch.where(((nrm * rd_w).sum(-1, keepdim=True) > 0), -nrm, nrm)
        pts = ro_w + torch.where(ok, hit.t, 0.0)[:, None] * rd_w \
            + big_cfg.shadow_bias * nrm
        g = torch.Generator(device=dev).manual_seed(SEED + 3)
        u = torch.rand((2, R), generator=g, device=dev)
        bounce = hemisphere_cos(nrm, u[0], u[1], 2.0).contiguous()
        k4_wave(big, "diffuse bounce rays", pts.contiguous(), bounce, t_big,
                ok, False, False)
        to_l = big.lights.pos[0][None, :].float() - pts
        dist = to_l.norm(dim=-1)
        k4_wave(big, "shadow rays", pts.contiguous(),
                (to_l / dist[:, None]).contiguous(),
                (dist - big_cfg.shadow_bias).contiguous(), ok, True, False)
        return prim_row

    def big_path(big):
        r = Renderer(big, big_cam, big_cfg, BIG_SIZE, BIG_SIZE)
        r.render()                                          # warm-up
        (img, st), secs = timed(lambda: r.render(return_state=True))
        rays = float(st["rays"])
        log(f"terrain {big.n_tris} render {BIG_SIZE}x{BIG_SIZE} {BIG_SPP} "
            f"spp depth {BIG_DEPTH}: {rays:.0f} rays in {secs:.3f} s, "
            f"{rays / secs:.1f} rays/s")
        require(img.shape == (BIG_SIZE, BIG_SIZE, 3), img.shape)
        require(torch.isfinite(img).all(), "finite terrain image")
        require(img.mean().item() > 0.0, "terrain image not black")
        return r, img

    for n_t in terrain.SIZES:
        with Phase(f"terrain {n_t} build"):
            big = terrain_build(n_t)
        if n_t == terrain.BIG_N:
            with Phase("K4 stream vs plain"):
                # 16,384 of wave 0's primary rays and as many random rays
                # from inside the world box; opaque, then with every other
                # triangle half transparent (the stochastic-alpha lottery,
                # keyed on ray ids that are not 0..R-1 and a salt)
                ro_w, rd_w, _, _ = Renderer(big, big_cam, big_cfg, BIG_SIZE,
                                            BIG_SIZE).wave_inputs(0)
                g = torch.Generator(device=dev).manual_seed(SEED + 2)
                lo_w, hi_w = big.world_min, big.world_max
                ro = torch.cat([ro_w[:K4_RAYS], lo_w + (hi_w - lo_w)
                                * torch.rand((K4_RAYS, 3), generator=g,
                                             device=dev)]).contiguous()
                rd = torch.cat([rd_w[:K4_RAYS], normalize(torch.randn(
                    (K4_RAYS, 3), generator=g, device=dev))]).contiguous()
                R = ro.shape[0]
                accept_b = trace_tables(big)[1]
                half = torch.where((torch.arange(accept_b.shape[0],
                                                 device=dev) % 2 == 1)
                                   & (accept_b > 0), 0.5, accept_b)
                rid = (torch.randperm(R, generator=g, device=dev) * 7 + 3) \
                    .to(torch.int32)
                k4_err = max(
                    k4_gates(big, ro, rd, accept_b, 0, rays_for(R)[2],
                             big.all_opaque, "opaque"),
                    k4_gates(big, ro, rd, half, 12345, rid, False, "alpha"))
                del ro, rd, ro_w, rd_w, half, rid
        if n_t == terrain.BIG_N:
            walk_resources("stream", stream_boxes(big).shape[1])
        with Phase(f"K4 terrain {n_t} rays"):
            k4 = k4_rays(big, n_t)
        with Phase(f"phase A: terrain {n_t}"):
            r, img = drive(f"phase A terrain {big.n_tris}",
                           lambda: big_path(big),
                           need=("stream", "wave_inputs"),
                           absent=("intersect", "megakernel"))
        if n_t == terrain.BIG_N:
            save_png(r, img, "terrain_256.png")
            profile(f"terrain {big.n_tris} render", r.render)
        del big, r, img
    ms, plain_ms, b_ms, b_by = k4
    rows["stream"] = dict(
        name="stream", route="cuda",
        source="gi_raytracer_tpu_torch/csrc/stream.cu",
        replaces="gi_raytracer_tpu/ops/pallas_intersect.py:388",
        max_abs_err=k4_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # ---- 6. phase B: the high-poly glass box ------------------------------
    glass_cfg = RenderConfig(min_samples=GLASS_SPP, max_samples=GLASS_SPP,
                             adaptive=False, max_depth=GLASS_DEPTH,
                             photons=GLASS_PHOTONS, knn_k=KNN_K, seed=SEED)
    with Phase("glass build"):
        glass, t_build = timed(lambda: cornell_box(
            SceneBuilder, meshgen, True, GLASS_SUBDIVS).build(device=dev))
        require(glass.n_tris == GLASS_TRIS, glass.n_tris)
        require(routes.trace(glass)[0] == "k4"
                and routes.wave(glass, glass_cfg)[0] == "staged",
                "the glass box takes the staged wave on K4")
        log(f"glass box {glass.n_tris} triangles built in {t_build:.3f} s")
    with Phase("K4 glass photon round"):
        walk_round("K4 glass photon round", cs.prim_query_stream, glass,
                   (stream_boxes(glass), chunk_boxes(glass)),
                   photon_round(glass, glass_cfg), glass_cfg.epsilon)

    with Phase("phase B: high-poly glass"):
        r, img = drive("phase B", lambda: glass_path(glass, glass_cfg, cam),
                       need=("stream", "knn"),
                       absent=("intersect", "megakernel"))
    save_png(r, img, "glass_256.png")
    profile(f"glass {glass.n_tris} render with the map", r.render)
    with Phase("glass photon pass profile"):
        profile(f"glass {glass.n_tris} photon pass, one chunk",
                lambda: trace_photons(glass, glass_cfg.replace(
                    photons=glass_cfg.ray_chunk)), host=False)

    del glass, r, img

    # ---- 7. phase C: the analytic Cornell box, the map, adaptive --------
    c_cfg = RenderConfig(min_samples=ADAPT_MIN, max_samples=ADAPT_MAX,
                         noise_thresh=ADAPT_THRESH, adaptive=True,
                         max_depth=DEPTH, photons=PHOTONS, knn_k=KNN_K,
                         seed=SEED)
    with Phase("analytic build"):
        an = cornell_box(SceneBuilder, meshgen, True, analytic=True,
                         seed=SEED).build(device=dev)
        require((an.n_tris, an.n_spheres, an.n_cones) == (ANALYTIC_TRIS, 2, 1),
                (an.n_tris, an.n_spheres, an.n_cones))
        require(an.has_image_tex and routes.trace(an)[0] == "k2"
                and routes.wave(an, c_cfg)[0] == "staged",
                "the staged wave on K2")

    def analytic_path():
        batch, t_ph = timed(lambda: trace_photons(an, c_cfg))
        stored = int(batch.stored.sum())
        apm, t_map = timed(lambda: build_photon_map(
            batch, an.world_min.cpu().numpy(), an.world_max.cpu().numpy()))
        log(f"phase C photons stored {stored} of {PHOTONS} "
            f"({stored / PHOTONS:.5f}) in {t_ph:.3f} s: "
            f"{PHOTONS / t_ph:.1f} photon slots/s; map {apm.dims} "
            f"window_cap {apm.window_cap} built in {t_map:.3f} s")
        require(stored >= MIN_STORED * PHOTONS, stored)
        r = Renderer(an, cam, c_cfg, WIDTH, HEIGHT, photon_map=apm)
        require(r.block_adaptive, "block-adaptive waves")
        (img, st), secs = timed(lambda: r.render(return_state=True))
        rays = float(st["rays"])
        log(f"phase C render {WIDTH}x{HEIGHT} adaptive {ADAPT_MIN}-"
            f"{ADAPT_MAX} spp (noise {ADAPT_THRESH}) depth {DEPTH} with the "
            f"map: waves {st['wave']}, active blocks per wave "
            f"{r.wave_blocks}; {rays:.0f} rays in {secs:.3f} s, "
            f"{rays / secs:.1f} rays/s")
        return apm, r, img, st

    with Phase("phase C: analytic Cornell"):
        apm, r, img, st = drive("phase C", analytic_path,
                                need=("intersect", "knn"),
                                absent=("megakernel", "stream"))
        require(img.shape == (HEIGHT, WIDTH, 3), img.shape)
        require(torch.isfinite(img).all(), "finite analytic image")
        require(blocks_never_grow(r.wave_blocks), r.wave_blocks)
        walls_gate(img, WIDTH)
        save_png(r, img, "analytic_512.png")
    with Phase("phase C full-frame waves"):
        _, img_f, st_f, secs_f = adaptive_render(an, c_cfg, apm, False)
        off = ((img - img_f).abs().max(-1).values > K1_LANE_TOL) \
            .float().mean().item()
        log(f"phase C the same waves on the full frame: "
            f"{float(st_f['rays']):.0f} rays in {secs_f:.3f} s (compacted "
            f"{float(st['rays']):.0f}); pixels off >{K1_LANE_TOL} {off:.6f}")
        require(float(st["rays"]) < float(st_f["rays"]),
                "compacted waves trace fewer rays")
        require(torch.equal(st["samps"], st_f["samps"])
                and torch.equal(st["active"], st_f["active"]),
                "the same samples and active pixels")
        require(off < K1_MAX_OFF, ("phase C full frame", off))
        del img_f, st_f
    profile("phase C render", r.render)
    del an, apm, r, img, st

    # ---- 8. phase D: the fog Cornell box --------------------------------
    from gi_raytracer_tpu_torch.render import atmosphere
    d_cfg = RenderConfig(min_samples=FOG_SPP, max_samples=FOG_SPP,
                         adaptive=False, max_depth=FOG_DEPTH, photons=0,
                         ambient=FOG_AMBIENT, seed=SEED)
    with Phase("fog build"):
        fb = cornell_box(SceneBuilder, meshgen, True)
        fb.add_height_fog(FOG["pos"], FOG["size"], FOG["col"],
                          FOG["density"], FOG["scatter"], FOG["noise_scale"],
                          seed=SEED)
        fog = fb.build(device=dev)
        require(fog.n_tris == FULL_TRIS and fog.has_fog
                and routes.wave(fog, d_cfg) == ("staged", ["fog"]),
                "fog: no K1")
        clear = cornell_box(SceneBuilder, meshgen, True).build(device=dev)

    def fog_path():
        r = Renderer(fog, cam, d_cfg, WIDTH, HEIGHT)
        (img, st), secs = timed(lambda: r.render(return_state=True))
        rays = float(st["rays"])
        log(f"phase D fog render {WIDTH}x{HEIGHT} {FOG_SPP} spp depth "
            f"{FOG_DEPTH}: {rays:.0f} rays in {secs:.3f} s, "
            f"{rays / secs:.1f} rays/s")
        return r, img

    with Phase("phase D: fog Cornell"):
        r, img = drive("phase D", fog_path, need=("intersect", "fog_march"),
                       absent=("megakernel", "stream", "knn"))
        require(torch.isfinite(img).all(), "finite fog image")
        img_c = Renderer(clear, cam, d_cfg, WIDTH, HEIGHT).render()
        diff = (img - img_c).abs().mean().item()
        log(f"phase D mean |fog - no fog| {diff:.5f}")
        require(diff > FOG_MIN_DIFF, ("fog visible", diff))
        save_png(r, img, "fog_512.png")
    with Phase("fog march"):
        rows["fog_march"] = fog_march_row(fog, cam, d_cfg)
    # the march's share: its kernels' device time in the profile, and the
    # stream time between events around each march
    march = atmosphere.march
    marks = []

    def timed_march(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function("fog_march"):
            e0.record()
            out = march(*a, **kw)
            e1.record()
        marks.append((e0, e1))
        return out

    atmosphere.march = timed_march
    try:
        busy, march_ms = profile("phase D fog render", r.render,
                                 span="fog_march")
    finally:
        atmosphere.march = march
    torch.cuda.synchronize()
    stream_ms = sum(a.elapsed_time(b) for a, b in marks)
    log(f"phase D fog march: {len(marks)} marches, device ms {march_ms:.1f} "
        f"of {busy:.1f} busy ({march_ms / busy:.4f}); stream ms between "
        f"the marches' events {stream_ms:.1f}")
    del fog, clear, r, img, img_c

    # ---- 9. the CLI on the card: render, checkpoint, resume ---------------
    from gi_raytracer_tpu_torch import cli
    from gi_raytracer_tpu_torch import io as port_io
    with tempfile.TemporaryDirectory() as tmp:
        scn = os.path.join(tmp, "scene.scn")
        with open(scn, "w") as f:
            f.write(CLI_SCENE)
        png, ck = os.path.join(tmp, "full.png"), os.path.join(tmp, "ck.npz")
        args = ["render", scn, "-W", str(CLI_SIZE), "-H", str(CLI_SIZE),
                "--photons", str(CLI_PHOTONS), "--checkpoint", ck]

        class Interrupted(Exception):
            pass

        def cli_path():
            cli.main(args + ["-o", png])
            save = port_io.save_checkpoint

            def save_then_stop(*a, **kw):      # interrupted after wave 0
                save(*a, **kw)
                raise Interrupted

            port_io.save_checkpoint = save_then_stop
            try:
                cli.main(args + ["-o", os.path.join(tmp, "never.png")])
            except Interrupted:
                pass
            finally:
                port_io.save_checkpoint = save
            require(int(port_io.load_checkpoint(ck)["wave"]) == 1,
                    "a checkpoint after the first wave")
            cli.main(args + ["-o", os.path.join(tmp, "resumed.png"),
                             "--resume"])

        with Phase("CLI render and resume"):
            drive("CLI render", cli_path, need=("intersect", "knn"),
                  absent=("megakernel", "stream"))
            full = port_io.load_png(png)
            resumed = port_io.load_png(os.path.join(tmp, "resumed.png"))
            log(f"CLI png {full.shape} mean {full.mean():.5f}; resumed "
                f"equal {bool((full == resumed).all())}")
            require(full.shape == (CLI_SIZE, CLI_SIZE, 3), full.shape)
            require(full.max() > 0.05, "CLI image not black")
            require((full == resumed).all(), "resumed render equals the "
                    "uninterrupted one")

        # the same render under --profile: the same PNG, and a trace that
        # holds every K2, round kernel and K3 launch the counters saw in
        # the profiled region (the photon pass and the render)
        profiled = os.path.join(tmp, "profiled.png")
        trace_dir = os.path.join(tmp, "trace")
        region = {}
        profiled_region = cli._profiled

        @contextlib.contextmanager
        def counted_region(*a, **kw):
            before = dict(_cuda.launches)
            with profiled_region(*a, **kw):
                yield
            region.update({k: _cuda.launches[k] - before.get(k, 0)
                           for k in _cuda.KERNELS})

        with Phase("CLI render --profile"):
            cli._profiled = counted_region
            try:
                drive("CLI render --profile",
                      lambda: cli.main(args + ["-o", profiled, "--profile",
                                               trace_dir]),
                      need=("intersect", "knn"),
                      absent=("megakernel", "stream"))
            finally:
                cli._profiled = profiled_region
            counted = {"gi_walk_kernel": region["intersect"]
                       + region["photon_round"],
                       "gi_knn_kernel": region["knn"],
                       "gi_knn_focal_kernel": region["knn"]}
            with open(profiled, "rb") as f, open(png, "rb") as g:
                require(f.read() == g.read(), "the profiled render's PNG "
                        "equals the unprofiled one bit for bit")
            traces = [n for n in os.listdir(trace_dir)
                      if n.endswith(".pt.trace.json")]
            require(len(traces) == 1, ("one trace", traces))
            trace = os.path.join(trace_dir, traces[0])
            with open(trace) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
            busy = sum(e["dur"] for e in events
                       if e.get("cat") == "kernel") / 1e3
            log(f"CLI --profile trace: {os.path.getsize(trace)} bytes, "
                f"{len(events)} events, {len(kernels)} kernel events, "
                f"kernel ms {busy:.1f}")
            for name, n in counted.items():
                seen = sum(name in k for k in kernels)
                log(f"CLI --profile trace: {name} {seen} kernel events, "
                    f"{n} launches counted in the profiled region")
                require(0 < seen == n, ("kernel events in the trace", name,
                                        seen, n))
            del events, kernels

    # ---- 10. gradients: the train step, gradcheck, cli grad-check --------
    grad_phase(dev, scene, cam, cfg, cornell_batch, drive)
    del cornell_batch

    # ---- 11. the bench, and the main path over two ranks ------------------
    gc.collect()
    torch.cuda.empty_cache()
    bench_phase()
    dist_phase(dev, scene, cam, cfg, launches)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{key: dict(rows[k], launches=launches[k])[key] for key in keys}
             for k in _cuda.KERNELS]
    log(json.dumps({"kernels": table}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
