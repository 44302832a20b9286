"""``parallel.mesh`` and ``trace_photons_sharded`` on two gloo ranks on the
CPU: each sharded result equals the single-process port (the wave, the
photon batch and the fixed-spp and block-adaptive renders bit for bit,
ray counts equal; the train step's loss and parameters within rel 1e-5),
and the sharded photon pass equals the JAX package's
``trace_photons_sharded`` on 2 of its 8 virtual devices.

The ranks are spawned once for the module (``run_ranks``: a ``file://``
rendezvous in a temporary directory, one torch thread a rank, a timeout
on every wait).  The rank function lives here, so a rank imports this
module: JAX is imported inside the one test that needs it."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gi_raytracer_tpu_torch import entry
from gi_raytracer_tpu_torch.config import RenderConfig
from gi_raytracer_tpu_torch.parallel import mesh as pmesh
from gi_raytracer_tpu_torch.render import Camera, Renderer
from gi_raytracer_tpu_torch.render.integrator import radiance_wave
from gi_raytracer_tpu_torch.render.photon import (PhotonBatch,
                                                  build_photon_map,
                                                  trace_photons,
                                                  trace_photons_sharded)
from gi_raytracer_tpu_torch.train import TrainStep

# one intra-op thread a test worker, as tests/_torch_parity.py sets
torch.set_num_threads(1)

RANKS = 2
PER = 64                  # photon slots a rank
SIZE = 32                 # 16 rows a rank
CFG = RenderConfig(min_samples=2, max_samples=2, max_depth=3, adaptive=False,
                   photons=RANKS * PER, photon_retries=8, ray_chunk=PER)
ADAPTIVE = CFG.replace(min_samples=2, max_samples=4, adaptive=True,
                       noise_thresh=0.01)
LR = 0.05


def _setup(device):
    scene = entry.tiny_scene(device=device)
    return scene, Camera(**entry.CAMERA)


def _map(scene, batch):
    return build_photon_map(batch, scene.world_min.cpu().numpy(),
                            scene.world_max.cpu().numpy())


def _work(mesh):
    """Every sharded path of one rank, as CPU tensors."""
    scene, cam = _setup(mesh.device)
    batch = trace_photons_sharded(scene, CFG, mesh)
    pm = _map(scene, batch)
    ro, rd, sx, sy = Renderer(scene, cam, CFG, 16, 16).wave_inputs(0)
    wave = pmesh.render_wave_sharded(mesh, scene, CFG, ro, rd, sx, sy,
                                     photon_map=pm, lane_base=256)
    out = {"batch": [t.cpu() for t in batch], "wave": wave.cpu()}
    for name, cfg in (("fixed", CFG), ("adaptive", ADAPTIVE)):
        r = Renderer(scene, cam, cfg, SIZE, SIZE, photon_map=pm)
        st = pmesh.render_fused_sharded(r, mesh)
        out[name] = {k: v.cpu() if torch.is_tensor(v) else v
                     for k, v in st.items()}
        out[name + "_blocks"] = r.wave_blocks
    step = TrainStep(scene, cam, CFG, batch, size=16, depth=3,
                     photons=RANKS * PER)
    loss, new = pmesh.train_step_sharded(mesh, step.params(), step.build,
                                         step.cfg, *step.inputs, step.target,
                                         lr=LR)
    out["train"] = (float(loss), {k: v.cpu() for k, v in new.items()})
    out["backend"] = mesh.backend
    # rank r's scene offset by r, replicated from rank 0; a tree sharded
    lights = dataclasses.replace(scene.lights,
                                 pos=scene.lights.pos + mesh.rank)
    rep = pmesh.replicate(mesh, dataclasses.replace(scene, lights=lights))
    out["replicated"] = rep.lights.pos.cpu()
    out["shard"] = pmesh.shard_batch(mesh, {"ro": ro, "t": (sx.T,)})
    return out


@pytest.fixture(scope="module")
def ranks():
    return pmesh.run_ranks(_work, RANKS, device="cpu", threads=1,
                           timeout=240)


@pytest.fixture(scope="module")
def single():
    scene, cam = _setup("cpu")
    return scene, cam, trace_photons(scene, CFG)


def test_sharded_photons_equal_single_process(ranks, single):
    _, _, want = single
    assert want.stored.float().mean() > 0.9
    for out in ranks:
        assert out["backend"] == "gloo"
        for got, w in zip(out["batch"], want):
            assert torch.equal(got, w)


def test_sharded_wave_equals_single_process(ranks, single):
    scene, cam, batch = single
    ro, rd, sx, sy = Renderer(scene, cam, CFG, 16, 16).wave_inputs(0)
    want, _ = radiance_wave(scene, CFG, ro, rd, sx, sy, 0, _map(scene, batch),
                            lane_base=256)
    assert want.max() > 0.05
    for out in ranks:
        assert torch.equal(out["wave"], want)


@pytest.mark.parametrize("name,cfg", [("fixed", CFG), ("adaptive", ADAPTIVE)])
def test_fused_render_sharded_equals_single_process(ranks, single, name, cfg):
    """Image max error under 1e-5 (here: equal), samples, masks and the
    ray count equal; the adaptive render traces only active blocks in
    each band (the bands' blocks sum to the frame's)."""
    scene, cam, batch = single
    r = Renderer(scene, cam, cfg, SIZE, SIZE, photon_map=_map(scene, batch))
    img, st = r.render(return_state=True)
    for out in ranks:
        got = out[name]
        assert float((got["mean"] - img).abs().max()) < 1e-5
        assert torch.equal(got["mean"], img)
        for k in ("var", "samps", "active"):
            assert torch.equal(got[k], st[k]), k
        assert got["wave"] == st["wave"]
        assert float(got["rays"]) == float(st["rays"])
    if name == "adaptive":
        assert st["wave"] > 2 and r.block_adaptive
        assert [a + b for a, b in zip(ranks[0][name + "_blocks"],
                                      ranks[1][name + "_blocks"])] \
            == r.wave_blocks


def test_sharded_train_step_agrees(ranks, single):
    scene, cam, batch = single
    step = TrainStep(scene, cam, CFG, batch, size=16, depth=3,
                     photons=RANKS * PER)
    loss, new = step.sgd(LR)
    assert loss > 0
    for out in ranks:
        got_loss, got = out["train"]
        assert abs(got_loss - float(loss)) <= 1e-5 * float(loss)
        for k, v in new.items():
            assert torch.allclose(got[k], v, rtol=1e-5, atol=0), k
        assert not torch.equal(got["lcol"], step.params()["lcol"])


def test_sharded_photons_equal_jax_sharded(ranks):
    """JAX ``trace_photons_sharded`` on 2 of the 8 virtual devices: stored
    mask equal, colours within rtol 1e-6; positions and directions within
    1e-3 and 1e-5, the bounds of test_torch_rng_lowdisc's single-device
    comparison (sin/cos/acos differ in their last bits between XLA and
    torch, and the glass sphere magnifies that)."""
    import jax
    import __graft_entry__ as ge
    from gi_raytracer_tpu.config import RenderConfig as JaxConfig
    from gi_raytracer_tpu.parallel import make_mesh
    from gi_raytracer_tpu.render.photon import trace_photons_sharded as jts

    jcfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(CFG).items()})
    want = jts(ge._tiny_scene(np.float32), jcfg,
               make_mesh(RANKS, jax.devices()[:RANKS]))
    got = PhotonBatch(*ranks[0]["batch"])
    ws = np.asarray(want.stored)
    assert np.array_equal(got.stored.numpy(), ws)
    np.testing.assert_allclose(got.col.numpy()[ws], np.asarray(want.col)[ws],
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.dir.numpy()[ws], np.asarray(want.dir)[ws],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.pos.numpy()[ws], np.asarray(want.pos)[ws],
                               rtol=0, atol=1e-3)


def test_replicate_and_shard_batch(ranks, single):
    """``replicate`` gives every rank rank 0's tensors; ``shard_batch``
    rank r's rows of every tensor of a tree."""
    scene, cam, _ = single
    ro, _, sx, _ = Renderer(scene, cam, CFG, 16, 16).wave_inputs(0)
    for r, out in enumerate(ranks):
        assert torch.equal(out["replicated"], scene.lights.pos)
        rows = slice(r * 128, (r + 1) * 128)
        assert torch.equal(out["shard"]["ro"], ro[rows])
        assert torch.equal(out["shard"]["t"][0], sx.T[rows])


def test_init_distributed_single_process(tmp_path):
    mesh = pmesh.init_distributed(f"file://{tmp_path}/rendezvous", 1, 0,
                                  device="cpu")
    try:
        assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        assert pmesh.make_mesh(1, device="cpu") == mesh
        x = torch.arange(4.0)
        assert torch.equal(pmesh.all_reduce(mesh, x), x)
        assert torch.equal(pmesh.all_gather(mesh, x > 1), x > 1)
        with pytest.raises(ValueError):
            pmesh.make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_two_ranks(capsys):
    entry.dryrun_multichip(RANKS, device="cpu", threads=1)
    assert "render_err=0.00e+00" in capsys.readouterr().out


SCN = """colorTex 0.9 0.9 0.9
colorTex 0 0 0
colorTex 0.8 0.3 0.2
mat 0 1 1 1
mat 0 1 0 0 1.5
mat 2 1 1 1
box 0 -3 0 7 0.2 7 0 0 0 0
box 3 0 0 0.2 6 6 0 0 0 2
sphere 0 -1.2 0 1.2 1
light 0 3 0 8 8 8 0.3
samples 1 2 0.05
camera 0 0 -8 0 -1 0
"""


def test_cli_render_devices_equals_single_process(tmp_path, capsys):
    """``cli render --devices 2`` (two spawned gloo ranks) writes the PNG
    of the single-process ``cli render`` (no photons here: a sharded
    photon pass keys its chunks by rank, so it equals the single process
    only with ``ray_chunk`` = slots / ranks, as the tests above hold)."""
    from gi_raytracer_tpu_torch import cli, io
    scn = tmp_path / "s.scn"
    scn.write_text(SCN)
    args = ["render", str(scn), "--device", "cpu", "-W", "32", "-H", "32",
            "--max-depth", "3", "--no-photons"]
    cli.main(args + ["-o", str(tmp_path / "one.png")])
    capsys.readouterr()
    cli.main(args + ["-o", str(tmp_path / "two.png"), "--devices", "2"])
    two = capsys.readouterr().out.splitlines()
    assert two[0].startswith("[scene] ") and len(two) == 3
    assert "sharded over 2 devices" in two[1] and "gloo" in two[1]
    assert two[2] == f"[out] {tmp_path / 'two.png'}"
    assert np.array_equal(io.load_png(str(tmp_path / "one.png")),
                          io.load_png(str(tmp_path / "two.png")))


def test_cli_render_distributed_under_torchrun(tmp_path):
    """``cli render --distributed``: two processes started by torchrun
    (standalone rendezvous on a free local port) join the group from the
    environment (``env://``) and write the single-process PNG."""
    import os
    import subprocess
    import sys
    from gi_raytracer_tpu_torch import cli, io
    scn = tmp_path / "s.scn"
    scn.write_text(SCN)
    args = ["render", str(scn), "--device", "cpu", "-W", "32", "-H", "32",
            "--max-depth", "3", "--no-photons"]
    cli.main(args + ["-o", str(tmp_path / "one.png")])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "gi_raytracer_tpu_torch.cli", *args,
         "-o", str(tmp_path / "two.png"), "--distributed"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "sharded over 2 devices" in res.stdout and "gloo" in res.stdout
    assert np.array_equal(io.load_png(str(tmp_path / "one.png")),
                          io.load_png(str(tmp_path / "two.png")))
