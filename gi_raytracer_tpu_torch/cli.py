"""Command-line interface: the ``render``, ``photons``, ``bench`` and
``grad-check`` subcommands.

Counterpart of ``gi_raytracer_tpu.cli``, with the same flags and output
lines, plus ``--device`` (the card by default; ``--device cpu`` runs every
kernel's plain version):

  python -m gi_raytracer_tpu_torch.cli render scene.scn -o out.png
  python -m gi_raytracer_tpu_torch.cli render scene.scn -o out.png \\
      -W 128 -H 128 --photons 20000 --checkpoint ck.npz --resume
  python -m gi_raytracer_tpu_torch.cli render scene.scn --profile trace/
  python -m gi_raytracer_tpu_torch.cli render scene.scn --devices 2
  torchrun --nproc-per-node 2 -m gi_raytracer_tpu_torch.cli render \\
      scene.scn --distributed
  python -m gi_raytracer_tpu_torch.cli photons scene.scn
  python -m gi_raytracer_tpu_torch.cli bench scene.scn --spp 8
  python -m gi_raytracer_tpu_torch.cli grad-check scene.scn -W 16

``photons`` runs the photon pass alone and prints its ``[photons] stored/
slots stored (s)`` line; ``bench`` times one fixed-spp render (after a
warm-up render) and prints one ``primary_paths_per_s`` JSON line.

``render --devices N`` spawns N local ranks (``parallel.mesh.run_ranks``)
and ``render --distributed`` makes this process one rank of a group
``torchrun`` started (``init_distributed``, ``env://``): the photon pass
is split by slots and the render by image rows
(``render_fused_sharded``), and rank 0 writes the PNG.

``grad-check`` prints one JSON line per gradient family of
``gradcheck.ALL_CHECKS`` (``grad_rel_err_<name>``: the analytic gradient
against central finite differences, at max(16, min(W, 64)) pixels square).

``--checkpoint`` saves the accumulation state after every wave (atomic
npz with a meta record of resolution, seed, sampling config and the scene
file's hash); ``--resume`` continues from it and refuses one whose record
differs.  ``--preview`` writes the tonemapped image after every wave.

``render --profile DIR`` wraps the photon pass, the render and its
tonemap (not the scene build) in ``torch.profiler`` and writes the trace
to ``DIR/<worker>.<ns>.pt.trace.json``, which TensorBoard's profiler
plugin, Perfetto and ``chrome://tracing`` read: on the card its kernels,
copies and fills (the device alone), on the CPU the host's ops, and a row
of the program's spans (photon pass, rounds, grid, frame, waves, syncs,
K3 calls: ``telemetry``) on the same clock.  It prints each span's count
and self time (the photon pass's rounds by route: ``photons.round[k2]``
for the round kernel, ``photons.round[staged]``; a wave's set-up as
``wave.inputs[kernel]`` or ``wave.inputs[torch]``) and, on the card, the
device's idle seconds by the span open when each gap began.  It acts on
the single-process render only (not with ``--devices`` or
``--distributed``), as in the JAX package, and leaves the image, the ray
count and the checkpoint as they are without it.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import hashlib
import json
import os
import re
import time

import numpy as np
import torch


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _profiled(trace_dir, device):
    """torch.profiler over the block, ended by a synchronize: on the card
    the device alone (its kernels, copies and fills, as the benchmark
    traces it), on the CPU the host's ops.  The program records its spans
    meanwhile (``telemetry``); they are added to the trace it writes to
    ``trace_dir`` on a row of their own, on the trace's clock.  Prints the
    trace's path, each span's count and self time, and the device's idle
    seconds by the span open when each gap began."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from . import telemetry

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
    worker = f"render_{os.getpid()}"
    telemetry.reset()
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
            trace_dir, worker_name=worker)) as prof:
        yield
        _sync(device)
    # the newest of this process's traces: the name ends in its time in ns
    path = max(glob.glob(os.path.join(glob.escape(trace_dir),
                                      f"{worker}.*.pt.trace.json")))
    spans = telemetry.records()
    print(f"[profile] torch.profiler trace written to {path}")
    if not _add_spans(path, spans):
        print("[profile] the program's spans were not added: no close of "
              "the trace's events found in its tail")
    for line in telemetry.report(spans, telemetry.device_events(prof)
                                 if on_card else []):
        print(f"[profile] {line}")
    telemetry.reset()


_BASE = re.compile(rb'"baseTimeNanoseconds":\s*(\d+)')
# a close of a list of objects, followed by more keys of the trace
_LIST_END = re.compile(rb"\}\s*(\])\s*,")


def _events_end(tail: bytes) -> int:
    """The offset in ``tail`` of the bracket that closes the trace's
    ``traceEvents``: the last close of a list of objects after which the
    rest of the file is the trace's closing keys (``"traceName"`` and, by
    torch's version, the logger's lists and the base time); -1 if none."""
    for m in reversed(list(_LIST_END.finditer(tail))):
        try:
            json.loads(b"{" + tail[m.end():])
        except ValueError:
            continue
        return m.start(1)
    return -1


def _add_spans(path, spans) -> bool:
    """Add ``spans`` to the events of the profiler's Chrome trace at
    ``path``, on its clock (its ``baseTimeNanoseconds``, at the head or
    the tail of the file by torch's version).  The events go in before
    the bracket that closes ``traceEvents``, and only the file's tail is
    written again (a trace of many kernels runs to hundreds of MB).
    False, and the file as it was, where its tail holds no such
    bracket."""
    from . import telemetry

    with open(path, "rb+") as f:
        head = f.read(1 << 16)
        size = f.seek(0, os.SEEK_END)
        start = max(size - (1 << 16), 0)
        f.seek(start)
        tail = f.read()
        at = _events_end(tail)
        if at < 0:
            return False
        base = _BASE.search(head) or _BASE.search(tail)
        events = telemetry.chrome_events(
            spans, int(base.group(1)) if base else 0, os.getpid())
        f.seek(start + at)
        f.write(b"," + json.dumps(events)[1:-1].encode() + tail[at:])
    return True


def _build(args, echo=print):
    from .render import Camera
    from .scene.scn import load_scene

    t0 = time.time()
    ls = load_scene(args.scene, device=args.device)
    cfg = ls.config
    if args.spp:
        cfg = cfg.replace(min_samples=args.spp, max_samples=args.spp)
    if args.max_depth:
        cfg = cfg.replace(max_depth=args.max_depth)
    if args.photons is not None:
        cfg = cfg.replace(photons=args.photons)
    cam = Camera(pos=ls.camera_pos, look_at=ls.camera_look_at)
    echo(f"[scene] {ls.scene.n_tris} tris, {ls.scene.n_spheres} spheres, "
         f"{ls.scene.lights.count} lights ({time.time() - t0:.2f}s)")
    return ls, cfg, cam


def _photon_map(ls, cfg, mesh=None, echo=print):
    """The scene's photon map (None without photons or lights), over the
    ranks of ``mesh`` where given; prints the ``[photons]`` line."""
    from .render.photon import (build_photon_map, trace_photons,
                                trace_photons_sharded)

    if cfg.photons <= 0 or ls.scene.lights.count == 0:
        return None
    t0 = time.time()
    if mesh is not None:
        count = cfg.photons - (cfg.photons % mesh.size)
        batch = trace_photons_sharded(ls.scene, cfg, mesh, count=count)
    else:
        batch = trace_photons(ls.scene, cfg)
    stored = int(batch.stored.sum())
    pm = build_photon_map(batch, ls.scene.world_min.cpu().numpy(),
                          ls.scene.world_max.cpu().numpy())
    echo(f"[photons] {stored}/{batch.stored.shape[0]} stored "
         f"({time.time() - t0:.2f}s)")
    return pm if stored else None


def _render_rank(mesh, args):
    """One rank of a sharded render: the scene on the rank's device, the
    photon pass split by slots, the frame by rows.  Returns (the lines to
    print, the tonemapped image) from rank 0, (None, None) elsewhere."""
    from .render.integrator import Renderer
    from .parallel.mesh import render_fused_sharded

    lines = []
    echo = lines.append if mesh.rank == 0 else (lambda _: None)
    args.device = str(mesh.device)
    ls, cfg, cam = _build(args, echo)
    pm = (_photon_map(ls, cfg, mesh, echo) if not args.no_photons
          else None)
    r = Renderer(ls.scene, cam, cfg, args.width, args.height, photon_map=pm)
    t0 = time.time()
    st = render_fused_sharded(r, mesh)
    img = r.tonemap(st["mean"])
    _sync(mesh.device)
    echo(f"[render] {time.time() - t0:.2f}s sharded over {mesh.size} "
         f"devices ({float(st['rays']):.3g} rays, {mesh.backend})")
    if mesh.rank:
        return None, None
    return lines, img.cpu()


def _render_sharded(args):
    from .io import save_png
    from .parallel.mesh import init_distributed, run_ranks

    if args.distributed:
        import torch.distributed as dist
        try:
            lines, img = _render_rank(init_distributed(device=args.device),
                                      args)
        finally:
            dist.destroy_process_group()
    else:
        lines, img = run_ranks(_render_rank, args.devices, args,
                               device=args.device)[0]
    if img is None:         # ranks past 0 of a --distributed group
        return
    for line in lines:
        print(line)
    save_png(args.output, img)
    print(f"[out] {args.output}")


def cmd_render(args):
    from .io import load_checkpoint, save_checkpoint, save_png
    from .render.integrator import Renderer

    if args.devices > 1 or args.distributed:
        return _render_sharded(args)
    ls, cfg, cam = _build(args)
    dev = ls.scene.device

    with open(args.scene, "rb") as f:
        scene_hash = hashlib.sha1(f.read()).hexdigest()[:16]
    meta = {"width": args.width, "height": args.height, "seed": cfg.seed,
            "min_samples": cfg.min_samples, "max_samples": cfg.max_samples,
            "max_depth": cfg.max_depth, "scene_sha1": scene_hash}

    state = None
    if args.resume and args.checkpoint and os.path.exists(args.checkpoint):
        raw = load_checkpoint(args.checkpoint, expect_meta=meta)
        raw.pop("meta", None)
        state = {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        state["wave"] = int(raw["wave"])
        print(f"[resume] wave {state['wave']} from {args.checkpoint}")

    def on_wave(st, s):
        # progressive preview and crash-safe accumulation
        if args.preview:
            save_png(args.preview, r.tonemap(st["mean"]))
        if args.checkpoint:
            save_checkpoint(args.checkpoint, meta=meta, **{
                k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
                for k, v in st.items()})
        if args.verbose:
            print(f"[wave {s}] active {int(st['active'].sum())}")

    hook = on_wave if (args.preview or args.checkpoint) else None
    region = (_profiled(args.profile, dev) if args.profile
              else contextlib.nullcontext())
    with region:
        pm = _photon_map(ls, cfg) if not args.no_photons else None
        r = Renderer(ls.scene, cam, cfg, args.width, args.height,
                     photon_map=pm)
        t0 = time.time()
        img, st = r.render(verbose=args.verbose, on_wave=hook, state=state,
                           return_state=True)
        out = r.tonemap(img)
    _sync(r.device)
    dt = time.time() - t0
    rays = float(st["rays"])
    if rays > 0:
        print(f"[render] {dt:.2f}s — {rays:.3g} rays traced "
              f"({rays / dt / 1e6:.2f} Mrays/s honest)")
    else:
        paths = args.width * args.height * cfg.max_samples
        print(f"[render] {dt:.2f}s ({paths / dt / 1e6:.2f} Mpaths/s "
              f"upper bound)")
    save_png(args.output, out)
    print(f"[out] {args.output}")


def cmd_photons(args):
    ls, cfg, cam = _build(args)
    _photon_map(ls, cfg)


def cmd_bench(args):
    """A timed fixed-spp render (after a warm-up render): one JSON line."""
    from .render.integrator import Renderer

    ls, cfg, cam = _build(args)
    cfg = cfg.replace(adaptive=False, min_samples=args.spp or 8,
                      max_samples=args.spp or 8)
    pm = _photon_map(ls, cfg) if not args.no_photons else None
    r = Renderer(ls.scene, cam, cfg, args.width, args.height, photon_map=pm)
    r.render()                  # warm-up
    _sync(r.device)
    t0 = time.time()
    r.render()
    _sync(r.device)
    dt = time.time() - t0
    spp = cfg.max_samples
    primary = args.width * args.height * spp
    print(json.dumps({"metric": "primary_paths_per_s",
                      "value": primary / dt, "unit": "paths/s",
                      "seconds": dt, "spp": spp,
                      "size": [args.width, args.height]}))


def cmd_grad_check(args):
    """Validate the renderer's gradients against central finite
    differences for every parameter family of ``gradcheck.ALL_CHECKS``;
    prints one JSON line per family (an ``error`` line for a family that
    raises, and the others still run)."""
    from . import gradcheck

    ls, cfg, cam = _build(args)
    ls.config = cfg
    size = max(16, min(args.width, 64))
    for name, fn in gradcheck.ALL_CHECKS.items():
        if name == "light_col" and ls.scene.lights.count == 0:
            continue    # ambient-only scenes
        try:
            rep = fn(ls, size=size)
        except Exception as e:  # report, keep checking the rest
            print(json.dumps({"metric": f"grad_rel_err_{name}",
                              "error": str(e)[:200], "pass": False}))
            continue
        print(json.dumps({"metric": f"grad_rel_err_{name}",
                          "value": rep.rel_err,
                          "analytic": np.asarray(rep.analytic).tolist(),
                          "fd": np.asarray(rep.fd).tolist(),
                          "pass": bool(rep.ok)}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="gi_raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("render", cmd_render), ("photons", cmd_photons),
                     ("bench", cmd_bench), ("grad-check", cmd_grad_check)):
        sp = sub.add_parser(name)
        sp.add_argument("scene")
        sp.add_argument("-o", "--output", default="render.png")
        sp.add_argument("-W", "--width", type=int, default=512)
        sp.add_argument("-H", "--height", type=int, default=512)
        sp.add_argument("--spp", type=int, default=0,
                        help="fixed samples/pixel (0 = scene adaptive)")
        sp.add_argument("--max-depth", type=int, default=0)
        sp.add_argument("--photons", type=int, default=None)
        sp.add_argument("--no-photons", action="store_true")
        sp.add_argument("--devices", type=int, default=1,
                        help="render: split photons and rows over N local "
                             "ranks")
        sp.add_argument("--distributed", action="store_true",
                        help="render: one rank of a torchrun group "
                             "(env://); the mesh spans every rank")
        sp.add_argument("--preview", default=None, metavar="PNG",
                        help="write a tonemapped preview after every wave")
        sp.add_argument("--checkpoint", default=None, metavar="NPZ",
                        help="save accumulation state after every wave")
        sp.add_argument("--resume", action="store_true",
                        help="resume from --checkpoint if it exists")
        sp.add_argument("--profile", default=None, metavar="DIR",
                        help="capture a torch.profiler trace of the render "
                             "(render, single process: not with --devices "
                             "or --distributed)")
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "plain versions)")
        sp.add_argument("-v", "--verbose", action="store_true")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
