"""gi_raytracer_tpu_torch — the PyTorch + CUDA port of gi_raytracer_tpu.

The JAX package (``gi_raytracer_tpu``) is the reference; this package
mirrors its module names so each counterpart is easy to find:

  scene/      host-side scene compiler (numpy) -> torch tensors
  sampling/   Halton QMC engine and the counter hash, bit-exact
  ops/        intersection (plain torch + CUDA trace kernel) and the
              bounce megakernel
  render/     camera, shading, staged integrator + Renderer, photon pass,
              kNN caustic estimate (plain torch + CUDA kernel), height fog
  io/         PNG output (standard library) and render checkpoints
  cli.py      ``python -m gi_raytracer_tpu_torch.cli render scene.scn``
  telemetry.py  spans and counters, recorded while a torch profiler runs
  csrc/       CUDA C++ sources for sm_90a, built by nvcc at first use
  convert.py  carries scenes, photon batches/maps and configs across from
              numpy arrays (used by the parity tests)

Every CUDA kernel has a plain PyTorch version in the same module.  A
wrapper takes the plain version only for CPU tensors; for a CUDA tensor it
launches the kernel or raises.  This package never imports JAX.
"""

__version__ = "0.1.0"
