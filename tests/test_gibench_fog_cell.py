"""The program's fog frame against the benchmark's plain reference
(``gibench/ref/fog.py``), through the benchmark's own run of a throwaway
copy of the cell ``cornell_fog.render`` at 32x32, 2 spp, depth 3 with a
denser fog (``_fog_cell.py``) on the CPU, on two seeded noise grids:
every 16x16 block is judged under the cell's own limits."""

import pytest
import torch

import _fog_cell
from gibench import run as bench_run


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("grid_seed, seed", [(0, 2**31 + 11),
                                             (5, 3_000_000_019)])
def test_fog_frame_agrees_with_the_reference(tmp_path, grid_seed, seed):
    bench, dirs = _fog_cell.write(tmp_path, grid_seed=grid_seed)
    line = bench_run.run_cell(bench, _fog_cell.NAME, seed, 0.1, False,
                              device="cpu", data_dirs=dirs)
    checks = line["checks"]
    assert line["correct"], checks
    assert set(checks) == {"img_rel_l1", "pix_off"}
    assert "frame_s" in line["metrics"]
