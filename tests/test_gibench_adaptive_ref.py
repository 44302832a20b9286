"""The benchmark's reference of the adaptive frame on the analytic Cornell
box (``gibench/ref/adaptive.py``) on the CPU: rendered over a subset of
the 16x16 blocks it equals its whole frame there, its sample counts
follow the adaptive rule, and the cell's judgement of
``cornell_analytic.adaptive_map`` (in a throwaway copy at 64x64,
``_adaptive_cell.py``) fails its bfloat16 control and the planted fault
of pixels that stop at half their samples."""

import pytest
import torch

import _adaptive_cell
from gibench import run as bench_run
from gibench.core import scene as sc
from gibench.core import spec
from gibench.ref import analytic
from gibench.ref.adaptive import AdaptiveFrame
from gibench.ref.build import SceneBuilder
from gibench.ref.camera import Camera
from gibench.ref.config import RenderConfig
from gibench.ref.photon import build_photon_map

SEED = 2**31 + 11


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as the suite's workers run: every run then splits
    the work alike.  (On eight threads one run in several read 15 of the
    20,000 photons off the reference, all in one thread's share of the
    slots; the runs after it read none.)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    conf = spec._json(spec.HERE, "configs", "cornell_analytic.json")
    scene = sc.populate(SceneBuilder, conf).build(device="cpu")
    cfg = RenderConfig(min_samples=4, max_samples=12, noise_thresh=0.0015,
                       max_depth=4, photons=2000, ray_chunk=2000, seed=SEED)
    batch = analytic.trace_photons(scene, cfg)
    pm = build_photon_map(batch, scene.world_min.numpy(),
                          scene.world_max.numpy())
    pos, at = sc.camera(conf, SEED)
    return AdaptiveFrame(scene, Camera(pos=pos, look_at=at), cfg, 48, 48,
                         photon_map=pm)


def test_a_subset_of_blocks_equals_the_whole_frame_there(frame):
    everything = torch.arange(frame.n_blocks)
    mean, taken, samps = frame.render_blocks(everything)
    some = torch.tensor([1, 4, 8])
    sub_mean, sub_taken, sub_samps = frame.render_blocks(some)
    at = frame.block_positions(some)
    assert torch.equal(sub_taken, taken[at])
    assert torch.equal(sub_samps, samps[at])
    assert torch.equal(sub_mean, mean[at])


def test_sample_counts_follow_the_adaptive_rule(frame):
    _, taken, samps = frame.render_blocks(torch.arange(frame.n_blocks))
    cfg = frame.cfg
    assert int(taken.min()) >= cfg.min_samples
    assert int(taken.max()) <= cfg.max_samples
    # a pixel that stopped early reached min_samples on its counter; the
    # counter gains 1 a sample and loses 2 for each extension
    done = taken < cfg.max_samples
    assert bool((samps[done] == cfg.min_samples).all())
    assert bool(((taken - samps) % 2 == 0).all())
    # the noisy pixels were extended, the quiet ones were not
    assert 0 < int(done.sum()) < taken.numel()
    assert bool((taken[samps == taken] == cfg.min_samples).all())


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return _adaptive_cell.write(tmp_path_factory.mktemp("adaptive_ref"))


def test_the_bfloat16_control_is_not_correct(cell):
    bench, dirs = cell
    line = bench_run.run_control(bench, _adaptive_cell.NAME, SEED,
                                 device="cpu", data_dirs=dirs)
    assert not line["correct"], line["checks"]


def test_pixels_stopping_at_half_their_samples_are_not_correct(tmp_path):
    # a smaller map: the fault is in the frame, and the map is judged too
    bench, dirs = _adaptive_cell.write(tmp_path, photons=4000,
                                       ray_chunk=4000)
    line = bench_run.run_control(bench, _adaptive_cell.NAME, SEED,
                                 device="cpu", data_dirs=dirs, fault="half")
    checks = line["checks"]
    assert not line["correct"], checks
    assert checks["samps_off"]["value"] > checks["samps_off"]["limit"]
    assert checks["photon_off"]["value"] == 0.0
