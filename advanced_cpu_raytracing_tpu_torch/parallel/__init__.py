"""Multi-card rendering over ``torch.distributed`` (the JAX package's
``parallel/``): ``mesh.py`` the process group and the 1-D ``tiles`` mesh,
``shard_render.py`` the sharded renders and differentiable steps,
``dryrun.py`` the multi-rank dry run."""

from advanced_cpu_raytracing_tpu_torch.parallel.mesh import make_device_mesh  # noqa: F401
