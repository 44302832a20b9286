"""The benchmark of ``gi_raytracer_tpu_torch`` on one NVIDIA H100.

``python3 gibench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything a cell is made of is found by name: its
configuration in ``configs/<config>.json`` (a scene generator of
``scenes/``), its traffic in ``traffic/<traffic>.json`` (a kind of entry of
``kinds/``), its limits in ``cells/<cell>.json`` and each metric in
``metrics/<metric>.py``.  ``ref/`` is the plain reference that decides
``correct``; it imports nothing of the program.
"""
