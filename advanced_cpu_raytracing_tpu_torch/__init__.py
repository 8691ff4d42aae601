"""advanced_cpu_raytracing_tpu_torch — the PyTorch + CUDA port of the ray
tracer in ``advanced_cpu_raytracing_tpu`` (JAX/Pallas), for NVIDIA Hopper.

The JAX package is the reference; this package keeps its sub-package layout
so each module's counterpart is easy to find:

  - ``scene``   host ingest: XML/PLY/image loading -> ``ScenePack`` of torch
                tensors
  - ``accel``   BVH build (numpy), used to order faces into coherent chunks
  - ``utils``   transforms (numpy) and batched 3-vector math (torch)
  - ``render``  camera rays, Gaussian multisampling, render_camera
  - ``ops``     the megakernel: host tables, the plain torch version and
                the wrapper of its CUDA variants (``csrc/mega_whitted.cu``
                Whitted, ``csrc/mega_pt.cu`` path tracing and mesh lights);
                ``rng.py`` its Philox4x32-10 draws
  - ``post``    Reinhard tonemapping and PNG/HDR writers
  - ``cli``     ``python -m advanced_cpu_raytracing_tpu_torch.cli.render``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
