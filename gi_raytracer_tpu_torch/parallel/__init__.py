from .mesh import (Mesh, make_mesh, init_distributed, shard_batch,  # noqa: F401
                   replicate, render_wave_sharded, render_fused_sharded,
                   train_step_sharded, run_ranks)
