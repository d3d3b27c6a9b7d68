"""vitgan_tpu_torch — the PyTorch and CUDA port of vitgan_tpu for NVIDIA Hopper.

The JAX package ``vitgan_tpu`` stays the reference; this package mirrors its
module names and parameter layouts and imports nothing of it or of JAX.
Ported so far: the v2 generator's serving path.

- ``vitgan_tpu_torch.config``  — the config dataclasses (JAX schema)
- ``vitgan_tpu_torch.ops``     — hand-written CUDA kernels (csrc/), their plain
                                 PyTorch versions, routing policy, the build
- ``vitgan_tpu_torch.models``  — layers and the v2 generator
- ``vitgan_tpu_torch.train``   — samplers
- ``vitgan_tpu_torch.serve``   — the batched HTTP sampling server
- ``vitgan_tpu_torch.cli``     — ``serve`` and ``generate``
"""

__version__ = "0.1.0"
