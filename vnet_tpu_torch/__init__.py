"""vnet_tpu_torch — the PyTorch / CUDA port of ``vnet_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference: every
module here is tested against its ``vnet_tpu`` counterpart on the same
inputs and weights (``tests/test_torch_*.py``). It imports ``torch`` and
never ``jax``. Host-side modules that import no JAX (``vnet_tpu.config``,
``vnet_tpu.io``, ``vnet_tpu.data``) are reused by import; callers reach
the first two through ``vnet_tpu_torch.config`` and ``vnet_tpu_torch.io``.

The first slice is whole-volume 3D V-Net evaluation
(``python -m vnet_tpu_torch -p evaluate --config_json F --device cuda``):
direct convolutions through PyTorch, and the sliding-window blend as a
hand-written CUDA kernel (``csrc/blend_accumulate.cu``). Kernels are built
with ``nvcc`` for ``sm_90a`` at first use (``ops/build.py``).
"""

__version__ = "0.1.0"
