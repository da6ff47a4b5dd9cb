"""dxrexperiments_tpu — a hybrid ray tracing framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
philcn/DXRExperiments (reference at /root/reference): progressive path
tracing, a realtime 1-spp pipeline with a separable joint-bilateral denoiser,
Phong BRDF shading with shadow rays and HDR environment lighting, two-level
acceleration structures, a fly camera, AOV debug views, and a parameter UI.

Layer map (the JAX re-expression of SURVEY.md §1; runs on a GPU or the CPU):
  core/      math, RNG, camera, timer            (replaces MiniEngine + utils)
  scene/     mesh import, materials, lights, env (replaces RtModel/RtScene + assimp)
  accel/     BVH builds, the lax BVH walk, TLAS  (replaces the Fallback Layer's BVH)
  ops/       brute-force ray/triangle tests      (replaces HLSL intersection code)
  trace/     wavefront trace engine              (replaces TraceRay/SBT dispatch)
  models/    render pipelines + denoiser         (replaces src/*Pipeline.cpp)
  parallel/  device mesh + shard_map sharding    (new: multi-device scaling)
  utils/     image IO, stats, process set-up     (replaces DirectXTK12 loaders, DXSample stats)
  app/       interactive/headless shells         (replaces Win32Application/DXSample)
"""

__version__ = "0.1.0"
