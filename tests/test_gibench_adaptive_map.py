"""The program's adaptive frame on the analytic Cornell box against the
benchmark's plain reference (``gibench/ref/analytic.py``,
``gibench/ref/adaptive.py``), through the benchmark's own run of a
throwaway copy of the cell ``cornell_analytic.adaptive_map`` at 64x64
(``_adaptive_cell.py``) on the CPU, on two seeds: every 16x16 block is
judged, so the sample counts (the samples each pixel took and the
state's counter) must be equal on every pixel, the stored photons equal
within ``PHOTON_POS_TOL``, and the image inside the cell's limits."""

import pytest
import torch

import _adaptive_cell
from gibench import run as bench_run


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
def cell(tmp_path_factory):
    return _adaptive_cell.write(tmp_path_factory.mktemp("adaptive"))


@pytest.mark.parametrize("seed", [2**31 + 11, 3_000_000_019])
def test_adaptive_frame_and_map_agree_with_the_reference(cell, seed):
    bench, dirs = cell
    line = bench_run.run_cell(bench, _adaptive_cell.NAME, seed, 0.1, False,
                              device="cpu", data_dirs=dirs)
    checks = line["checks"]
    assert line["correct"], checks
    assert checks["samps_off"]["value"] == 0.0
    assert checks["photon_off"]["value"] == 0.0
    lim = _adaptive_cell.limits()
    for name in ("img_rel_l1", "pix_off"):
        assert checks[name]["value"] <= lim[name], (name, checks)
