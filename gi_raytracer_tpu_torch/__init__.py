"""gi_raytracer_tpu_torch — the PyTorch + CUDA port of gi_raytracer_tpu.

The JAX package (``gi_raytracer_tpu``) is the reference; this package
mirrors its module names so each counterpart is easy to find:

  scene/      host-side scene compiler (numpy) -> torch tensors
  sampling/   Halton QMC engine and the counter hash, bit-exact
  ops/        intersection (plain torch + CUDA trace kernels), the packed
              prim rows and the other kernels' wrappers; it imports
              nothing from render/'s integrator or photon pass
  routes.py   every choice of kernel (the trace, a wave, its set-up, a
              photon round) with the reasons a kernel is refused
  render/     camera, shading, staged integrator + Renderer, photon pass,
              kNN caustic estimate (plain torch + CUDA kernel), height fog
  io/         PNG output (standard library) and render checkpoints
  cli.py      ``python -m gi_raytracer_tpu_torch.cli render scene.scn``
  telemetry.py  spans and counters, recorded while a torch profiler runs
  csrc/       CUDA C++ sources for sm_90a, built by nvcc at first use
  convert.py  carries scenes, photon batches/maps and configs across from
              numpy arrays (used by the parity tests)

Every CUDA kernel has a plain PyTorch version.  K2, K3 and K4 keep theirs
in their own module and take it for CPU tensors; the wrappers of K1, the
photon round and the wave set-up launch their kernel or raise, and their
callers hold the plain version.  This package never imports JAX.
"""

__version__ = "0.1.0"
