"""PyTorch/CUDA port of the HLS4PC point-cloud pipeline (``repro``'s twin).

The package mirrors ``repro`` module for module.  It imports ``torch``
and never ``jax`` or ``repro``: the JAX package is the reference the
port's tests hold it against, and it keeps its own copies of whatever it
needs from there.

Entry points (``repro_torch.api.build``, ``repro_torch.serve.pointcloud.
PointCloudEngine``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no device given and no GPU present they raise.
The hand-written CUDA kernels under ``csrc/`` build at first use (see
``repro_torch.kernels._build``).
"""
