"""burn_raymarching_tpu_torch — the PyTorch + CUDA port of burn_raymarching_tpu.

The JAX package (``burn_raymarching_tpu``) stays the reference; this package
mirrors its module paths and function names so each module's counterpart is
found by name. It imports nothing of the JAX package: ``config`` and
``utils`` are its own copies. Plain tensor code is PyTorch; the four Pallas
kernels are hand-written CUDA C++ for Hopper (``csrc/``), built with nvcc at
first use and bound with ctypes (``ops/cuda/``).

Layer map:
  config     — the four configuration dataclasses
  utils/     — padding buckets, Morton pixel orders, metrics logger,
               profiling (trace, annotate and TRACER, debug_mode), the
               device rule (device.resolve_device: the card unless the
               caller names the CPU; no card raises)
  ops/       — SDF math, soft-min, march, culling; ops/cuda: K1 march+normals,
               K2 shade, K3 culled march, K4 cluster repulsion
  models/    — SceneParams (nn.Module of raw params) + activations + forward
  render/    — differentiable + ground-truth renderers, tiled previews
  data/      — cameras, ray dataset + sampling, PNG (stdlib) and scene I/O
  train/     — loss, Adam, density control, step, multi-stage loop
  tools/     — generate / train CLIs, the offline and HTTP viewers, the
               capture tools (chromakey, COLMAP → cameras.json, camera
               processing; they need Pillow)
  native/    — ctypes bindings of the C++ host helpers (g++ at first use)

Numerics: fp32 throughout. TF32 is switched off here, at import, for both
matmuls and cuDNN: it keeps ~3 decimal digits, which corrupts the distance
field the march converges on.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
