"""The arithmetic of the metrics on synthetic runs and events, the K3
count against a hand count, and the check for JAX."""

import types

import pytest
import torch

from gibench.core import devtrace, guards, k3count, peaks, spec, stats


def test_p95_by_nearest_rank():
    assert stats.p95(range(1, 101)) == 95
    assert stats.p95([3.0]) == 3.0
    assert stats.p95([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                      16, 17, 18, 19, 100]) == 19


def _run(**kw):
    base = dict(jobs=[0.1, 0.2, 0.3, 0.4], units=[750, 750, 750, 750],
                window_s=1.0, setup_s=2.0, spans={}, counts={}, work={},
                dtrace=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_rates_and_times_over_the_window():
    run = _run()
    assert spec.module("metrics", "frame_s").read(run) == 0.25
    assert spec.module("metrics", "train_step_s").read(run) == 0.25
    assert spec.module("metrics", "photon_slots_per_s").read(run) == 3000
    assert spec.module("metrics", "frame_p95_s").read(run) == 0.4
    assert spec.module("metrics", "setup_s").read(run) == 2.0


def test_device_trace_busy_gaps_and_launches():
    recs = [("a", 0, 100), ("b", 100, 50), ("a", 400, 100),
            ("c", 450, 100)]            # c overlaps a: a union, not a sum
    tr = devtrace.reduce(recs)
    assert tr.busy_s == pytest.approx(300e-9)
    assert tr.kernels["a"] == [pytest.approx(200e-9), 2]
    assert tr.gaps == {"after b": pytest.approx(250e-9)}
    assert tr.launches() == 4 and tr.launches(("a",)) == 2
    assert tr.top(1) == [["a", pytest.approx(200e-9)]]
    run = _run(dtrace=tr, window_s=1000e-9)
    for cell in ("frame", "photons", "train"):
        idle = spec.module("metrics", f"device_idle_pct.{cell}").read(run)
        assert idle == pytest.approx(70.0)
    assert spec.module("metrics", "kernels_per_frame").read(run) == 1.0


def test_kernel_names_lose_their_qualifiers():
    assert devtrace.name_of("void (anonymous namespace)::gi_walk_kernel"
                            "<4>(float const*, int)") == "gi_walk_kernel<4>"


def test_metrics_without_a_trace_read_nothing():
    run = _run()
    for name in ("k1_roofline", "k2_roofline", "k3_roofline", "k4_roofline",
                 "kernels_per_map", "device_idle_pct.frame"):
        assert spec.module("metrics", name).read(run) is None


def test_roofline_bound_takes_the_larger_time():
    t, by = peaks.bound(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = peaks.bound(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)


def test_k4_roofline_from_rays_and_calls():
    tr = devtrace.reduce([("gi_walk_kernel", 0, 10**6)])
    # the program's counter is not the yardstick's: only the reference's
    # count of the frame's rays is read
    run = _run(jobs=[1.0], dtrace=tr, counts={"rays_per_frame": 5 * 10**6},
               work={"tris": 1000, "lights": 1, "waves_per_frame": 2,
                     "depth": 3, "ref_rays_per_frame": 1000})
    nbytes = 2 * 3 * 2 * 1000 * 36 + 1000 * 37
    want = 100 * max(41 * 1000 / 67e12, nbytes / 3.35e12) / 1e-3
    assert spec.module("metrics", "k4_roofline").read(run) == \
        pytest.approx(want)


def _tiny_map():
    """Six photons in a 2 x 1 x 1 grid: cell 0 holds four, cell 1 two."""
    pos = torch.tensor([[0.1, 0.5, 0.5], [0.2, 0.5, 0.5], [0.3, 0.5, 0.5],
                        [0.4, 0.5, 0.5], [1.5, 0.5, 0.5], [1.6, 0.5, 0.5]])
    return types.SimpleNamespace(
        pos=pos, dir=torch.zeros_like(pos), col=torch.ones_like(pos),
        valid=torch.ones(6, dtype=torch.bool),
        cell_start=torch.tensor([0, 4, 6], dtype=torch.int32),
        grid_min=torch.zeros(3), inv_cell=torch.ones(3), dims=(2, 1, 1),
        capacity=6)


def test_k3_count_against_a_hand_count():
    pm = _tiny_map()
    # one query in cell 0: its window is both cells (6 candidates); k = 2
    # takes the two nearest, photons 0 and 1... the query at x = 0.15
    pts = torch.tensor([[0.15, 0.5, 0.5]])
    ops, nbytes, parts = k3count.k3_work(pm, pts, 2)
    assert parts["candidates"] == 6
    assert ops == 6 * peaks.OPS_PER_CANDIDATE
    assert parts["cell_start_entries"] == 3          # entries 0, 1, 2
    assert parts["window_photons"] == 6
    assert parts["photons_within_rk"] == 2
    assert nbytes == 1 * 36 + 3 * 4 + 6 * 13 + 2 * 24


def test_k3_count_skips_far_sentinels():
    pm = _tiny_map()
    pts = torch.tensor([[0.15, 0.5, 0.5], [1e30, 0.0, 0.0]])
    _, nbytes, parts = k3count.k3_work(pm, pts, 2)
    assert parts["candidates"] == 6 and parts["queries"] == 2
    assert nbytes == 2 * 36 + 3 * 4 + 6 * 13 + 2 * 24


def test_jax_is_found_by_whole_top_level_names():
    assert guards.forbidden_modules(
        ["gi_raytracer_tpu_torch", "gi_raytracer_tpu_torch.ops", "torch",
         "jaxtyping", "flaxen"]) == []
    assert guards.forbidden_modules(
        ["gi_raytracer_tpu.render", "jax.numpy", "jaxlib", "flax"]) == \
        ["flax", "gi_raytracer_tpu", "jax", "jaxlib"]


def _imports(path):
    """Top-level names of every module a source file imports."""
    import ast
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax():
    import pathlib
    for p in pathlib.Path(spec.HERE).rglob("*.py"):
        assert not set(_imports(p)) & set(guards.FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    import pathlib
    for folder in ("ref", "scenes", "core"):
        for p in (pathlib.Path(spec.HERE) / folder).glob("*.py"):
            assert "gi_raytracer_tpu_torch" not in set(_imports(p)), p
