from advanced_cpu_raytracing_tpu_torch.diff.params import (  # noqa: F401
    extract_params,
    inject_params,
)
