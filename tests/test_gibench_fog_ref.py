"""The benchmark's plain fog reference (``gibench/ref/fog.py``) on the
CPU, on a throwaway copy of the cell ``cornell_fog.render`` at 32x32 with
a denser fog (``_fog_cell.py``): its step-by-step march equals the
program's blocked march lane for lane, rendered over a subset of the
16x16 blocks it equals its whole frame there, the cell's judgement fails
its bfloat16 control and the planted fault ``shadow_clear`` (shadow rays
that march no fog), and it loads neither JAX nor the program.  The
program's fog frame against it: ``test_gibench_fog_cell.py``."""

import os
import subprocess
import sys

import pytest
import torch

import _fog_cell
from gibench import run as bench_run
from gibench.core import scene as sc
from gibench.core import spec
from gibench.ref import fog as ref_fog
from gibench.ref.build import SceneBuilder
from gibench.ref.camera import Camera
from gibench.ref.config import RenderConfig
from gi_raytracer_tpu_torch.config import RenderConfig as PortConfig
from gi_raytracer_tpu_torch.render import atmosphere
from gi_raytracer_tpu_torch.scene import SceneBuilder as PortBuilder

SEED = 2**31 + 11
ROOT = os.path.dirname(spec.HERE)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    conf = _fog_cell.config()
    scene = sc.populate(SceneBuilder, conf).build(device="cpu")
    cfg = RenderConfig(min_samples=2, max_samples=2, adaptive=False,
                       max_depth=2, ambient=tuple(conf["ambient"]),
                       seed=SEED)
    pos, at = sc.camera(conf, SEED)
    return ref_fog.FogFrame(scene, Camera(pos=pos, look_at=at), cfg, 32, 32)


def test_the_march_equals_the_programs_lane_for_lane(frame):
    """Primary rays and rays from inside the box, on lane ids past 2^31,
    capped at random lengths: the scatter flags and t equal."""
    conf = _fog_cell.config()
    port = sc.populate(PortBuilder, conf).build(device="cpu")
    ro, rd, _, _ = frame.wave_inputs(1)
    g = torch.Generator().manual_seed(4)
    inner = (torch.rand((ro.shape[0], 3), generator=g) * 2 - 1) * 3.9
    ro = torch.cat([ro, inner])
    rd = torch.cat([rd, torch.nn.functional.normalize(
        torch.randn((inner.shape[0], 3), generator=g), dim=-1)])
    cap = torch.rand(ro.shape[0], generator=g) * 25
    lane = (3 << 31) + torch.arange(ro.shape[0])
    tmin, tmax, has = ref_fog._fog_bounds(frame.scene, ro, rd, cap)
    want = ref_fog._march_steps(frame.scene, frame.cfg, ro, rd, tmin, tmax,
                                has, 0x9E3779B9, ray_id=lane)
    got = atmosphere._march(port, PortConfig(), ro, rd, tmin, tmax, has,
                            0x9E3779B9, ray_id=lane)
    assert 0.2 < want[0].float().mean() < 0.9
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


def test_a_subset_of_blocks_equals_the_whole_frame_there(frame):
    mean, rays = frame.render_blocks(torch.arange(frame.n_blocks))
    some = torch.tensor([1, 2])
    sub_mean, sub_rays = frame.render_blocks(some)
    at = frame.block_positions(some)
    assert torch.equal(sub_mean, mean[at])
    assert torch.equal(sub_rays, rays[at])


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return _fog_cell.write(tmp_path_factory.mktemp("fog_ref"))


@pytest.mark.parametrize("fault", [None, "shadow_clear"],
                         ids=["bfloat16", "shadow_clear"])
def test_the_control_and_the_fault_are_not_correct(cell, fault):
    bench, dirs = cell
    line = bench_run.run_control(bench, _fog_cell.NAME, SEED, device="cpu",
                                 data_dirs=dirs, fault=fault)
    checks = line["checks"]
    assert not line["correct"], checks
    assert all(c["value"] > c["limit"] for c in checks.values()), checks


def test_the_reference_loads_neither_jax_nor_the_program():
    code = ("import sys; import gibench.ref.fog, gibench.kinds.fog; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'gi_raytracer_tpu', "
            "'gi_raytracer_tpu_torch'}))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
