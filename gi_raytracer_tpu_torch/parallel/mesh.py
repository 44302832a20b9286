"""Multi-process distribution of the renderer over ``torch.distributed``,
the counterpart of ``gi_raytracer_tpu.parallel.mesh``.

The JAX package runs one SPMD program over a 1-D device mesh; here a
``Mesh`` is the 1-D process group (axis "shard"), one process a rank, each
holding the whole scene and photon map on its device:

* rays, image rows and photon slots are split by rank; every stochastic
  stream is keyed on global lane and slot ids, so a sharded result equals
  the single-process one;
* ``render_fused_sharded`` gives each rank a band of image rows and runs
  the port's frame loop over it (``Renderer(rows=...)``); each wave ends
  with one all-reduce of the ray count (sum) and one of the go vote
  (max), and a rank whose band went quiet joins every collective until
  the vote stops everyone;
* ``train_step_sharded`` all-reduces the replicated parameters' gradients
  and takes the SGD step on every rank.

The backend follows what is there: NCCL when each rank of a host has a
card of its own, gloo when ranks share a card (NCCL refuses two ranks on
one GPU) or run on the CPU.  Tensors stay on each rank's device; gloo's
collectives go through a CPU copy (gloo gathers no CUDA tensors), which
costs one device-to-host copy a collective: a scalar per wave, about
30 MB for a 750k-slot photon batch.

``run_ranks(fn, n, ...)`` spawns n local ranks (a ``file://`` rendezvous
in a fresh temporary directory, so no port is taken) and returns each
rank's ``fn(mesh, *args)``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D process group (axis "shard", the default group) a render
    is split over: ``size`` ranks, this process's ``rank``, its
    ``device`` and the group's ``backend``."""
    size: int
    rank: int
    device: torch.device
    backend: str


def rank_device(device, rank: int, size: int) -> tuple:
    """(device of ``rank``, its backend): the CPU over gloo; its own card
    over NCCL where the host has a card for each of its ranks (torchrun's
    LOCAL_RANK and LOCAL_WORLD_SIZE, else one host); else the host's
    first card, shared, over gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu"), "gloo"
    from ..ops._cuda import resolve_device
    resolve_device(dev)
    local = int(os.environ.get("LOCAL_RANK", rank))
    if torch.cuda.device_count() >= int(os.environ.get("LOCAL_WORLD_SIZE",
                                                       size)):
        return torch.device("cuda", local), "nccl"
    return torch.device("cuda", dev.index or 0), "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> Mesh:
    """Join the process group and return the mesh over all its ranks.

    ``coordinator_address``: an ``init_method`` URL (``tcp://host:port``,
    ``file:///path``) or a bare ``host:port``; by default ``env://``, the
    variables ``torchrun`` sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK).  Each process calls this once, before building scenes."""
    url = coordinator_address or "env://"
    if "://" not in url:
        url = f"tcp://{url}"
    size = (num_processes if num_processes is not None
            else int(os.environ.get("WORLD_SIZE", 1)))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", 0)))
    dev, backend = rank_device(device, rank, size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if url == "env://" else dict(world_size=size, rank=rank)
    dist.init_process_group(backend, init_method=url, **kw)
    return make_mesh(device=device)


def make_mesh(n: int | None = None, device="cuda") -> Mesh:
    """The mesh over the process group that is already up (all of its
    ranks: ``n``, where given, must be its size)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n is not None and n != size:
        raise ValueError(f"a mesh of {n} ranks in a group of {size}")
    return Mesh(size, rank, rank_device(device, rank, size)[0],
                dist.get_backend())


# ---- collectives (through the CPU under gloo) -----------------------------

def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    t = t.detach()
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return (t.cpu() if mesh.backend == "gloo" else t).contiguous()


def all_reduce(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM):
    """The ranks' ``op`` of ``t`` (every rank passes the same shape)."""
    x = _wire(mesh, t).clone()
    dist.all_reduce(x, op=op)
    return x.to(device=t.device, dtype=t.dtype)


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in rank order (every rank
    passes the same shape)."""
    x = _wire(mesh, t)
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x)
    return torch.cat(out).to(device=t.device, dtype=t.dtype)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank."""
    x = _wire(mesh, t).clone()
    dist.broadcast(x, src=src)
    return x.to(device=t.device, dtype=t.dtype)


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _split(mesh: Mesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Mesh, tree):
    """This rank's share (dim 0, in rank order) of every tensor of
    ``tree``, on the rank's device."""
    return _tree_map(lambda x: x[_split(mesh, x.shape[0])].to(mesh.device),
                     tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` (a scene, a map, parameters) as rank 0
    holds it, on every rank's device."""
    return _tree_map(lambda x: broadcast(mesh, x.to(mesh.device)), tree)


# ---- sharded render, photon pass and train step ---------------------------

@torch.no_grad()
def render_wave_sharded(mesh: Mesh, scene, cfg, ro, rd, sx_all, sy_all,
                        wave_salt=0, photon_map=None, lane_base: int = 0):
    """The staged ``radiance_wave`` with its R rays split by rank (R a
    multiple of the size; ``sx_all``/``sy_all`` (D, R) split on the ray
    axis), each rank's lanes keeping their ids ``lane_base + i``.  Returns
    the gathered (R, 3) radiance on every rank."""
    from ..render.integrator import radiance_wave
    sl = _split(mesh, ro.shape[0])
    out, _ = radiance_wave(scene, cfg, ro[sl], rd[sl], sx_all[:, sl],
                           sy_all[:, sl], wave_salt, photon_map,
                           lane_base=int(lane_base) + sl.start)
    return all_gather(mesh, out)


def train_step_sharded(mesh: Mesh, params: dict, scene_fn, cfg, ro, rd,
                       sx_all, sy_all, target, lr: float = 0.05,
                       lane_base: int = 0):
    """One inverse-rendering SGD step, data-parallel over rays.

    ``params``: a dict of replicated tensors; ``scene_fn(params) ->
    (scene, photon_map)`` rebuilds the scene (and map, or None) around
    them.  The loss is mean((c - target)^2) over all R rays (split by
    rank, lane ids ``lane_base + i``) of the staged wave; every rank
    all-reduces its share of the loss and of the gradients and steps.
    Returns (loss, new params), equal on every rank."""
    from ..render.integrator import radiance_wave
    sl = _split(mesh, ro.shape[0])
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    scene, pm = scene_fn(p)
    c, _ = radiance_wave(scene, cfg, ro[sl], rd[sl], sx_all[:, sl],
                         sy_all[:, sl], 0, pm,
                         lane_base=int(lane_base) + sl.start)
    part = torch.sum((c - target[sl]) ** 2) / target.numel()
    grads = torch.autograd.grad(part, list(p.values()))
    loss = all_reduce(mesh, part.detach())
    new = {k: (v - lr * all_reduce(mesh, g)).detach()
           for (k, v), g in zip(p.items(), grads)}
    return loss, new


@torch.no_grad()
def render_fused_sharded(renderer, mesh: Mesh, state=None):
    """``renderer``'s whole render split by image rows over the mesh.

    Rank r renders rows [r*H/n, (r+1)*H/n) (H/n a multiple of 16) with a
    ``Renderer`` over that band: the frame's lane ids (full frame wave*N +
    r*lanes + j, block-adaptive wave*N + b*256 + j for the frame's block
    b), the frame's Halton indices, the same scene and map.  ``state``: a
    frame state to resume from.  Returns the frame's accumulation state
    (image leaves gathered from the bands) on every rank."""
    from ..render.integrator import Renderer

    r = renderer
    H, n = r.height, mesh.size
    if H % n or (H // n) % 16:
        raise ValueError(f"height {H} must split into 16-row blocks over "
                         f"{n} ranks")
    Hs = H // n
    rows = (mesh.rank * Hs, (mesh.rank + 1) * Hs)
    band = Renderer(r.scene, r.camera, r.cfg, r.width, H, r.photon_map,
                    block_compaction=r.block_compaction, rows=rows)
    if state is not None:
        state = {k: (v[rows[0]:rows[1]] if torch.is_tensor(v) and v.ndim >= 2
                     else v) for k, v in state.items()}
    st = band.start(state)

    def vote(st):
        return bool(all_reduce(mesh, st["active"].any().to(torch.int32),
                               dist.ReduceOp.MAX))

    go = vote(st)
    for s in range(int(st["wave"]), r.cfg.max_samples):
        if not go:
            break
        st = band.step(st, s, reduce_rays=lambda k: all_reduce(mesh, k))
        go = vote(st)
    r.wave_blocks = band.wave_blocks
    return {k: (all_gather(mesh, v) if torch.is_tensor(v) and v.ndim >= 2
                else v) for k, v in st.items()}


# ---- local ranks ----------------------------------------------------------

def _rank_main(rank, size, init_method, device, threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        mesh = init_distributed(init_method, size, rank, device=device)
        try:
            # pickled here by value: a tensor put on the queue as is would
            # travel as a handle to this process's memory, gone when it ends
            results.put((rank, True, pickle.dumps(fn(mesh, *args))))
        finally:
            dist.destroy_process_group()
    except BaseException:   # reported to the parent, which raises too
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, n: int, *args, device="cuda", threads: int | None = None,
              timeout: float = 600.0) -> list:
    """Spawn ``n`` local ranks, each calling ``fn(mesh, *args)`` (``fn`` and
    ``args`` picklable, results too), and return their results in rank
    order.  ``threads``: torch's intra-op threads a rank (on the CPU by
    default the host's cores shared out).  Raises if a rank fails or the
    ranks do not finish within ``timeout`` seconds (every rank is then
    terminated)."""
    import multiprocessing as mp
    import time
    if threads is None and torch.device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // n)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gi_ranks_")
    init = f"file://{os.path.join(tmp, 'rendezvous')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        rank, n, init, str(device), threads, fn, args, results))
        for rank in range(n)]
    got, errors = {}, []
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) + len(errors) < n:
            left = deadline - time.monotonic()
            try:
                rank, ok, out = results.get(timeout=max(min(left, 5.0), 0.1))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if left <= 0 or dead:
                    raise RuntimeError(
                        f"ranks unfinished after {timeout - max(left, 0):.0f}"
                        f" s (exit codes {[p.exitcode for p in procs]})")
                continue
            if ok:
                got[rank] = pickle.loads(out)
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
        if errors:
            raise RuntimeError("a rank failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
