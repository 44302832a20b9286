"""The benchmark's own tests: ``python -m pytest gibench/tests -q``.

Those marked ``cuda`` need the card and skip without it; on the card
``python -m pytest gibench/tests -q -m cuda`` runs them."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    import torch
    # the runs are small: a few threads each, so workers do not contend
    torch.set_num_threads(2)
    config.addinivalue_line("markers", "cuda: needs a CUDA device")
