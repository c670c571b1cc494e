"""vnet_tpu_torch — the PyTorch / CUDA port of ``vnet_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference: every
module here is tested against its ``vnet_tpu`` counterpart on the same
inputs and weights (``tests/test_torch_*.py``). It imports ``torch`` and
never ``jax``, and nothing of ``vnet_tpu``: the host modules it needs are
its own copies, laid out as in the JAX package (``config``, ``io``, the 3D
part of ``data``).

Two slices run on the card: 3D training (``python -m vnet_tpu_torch -p
train --config_json F --device cuda``), with dropout and the weight
gradient of the stride-1 convolutions as hand-written CUDA kernels
(``csrc/dropout.cu``, ``csrc/dw_conv.cu``), and whole-volume 3D evaluation
(``-p evaluate``), with the sliding-window blend as one
(``csrc/blend_accumulate.cu``). Convolutions otherwise run through cuDNN.
Kernels are built with ``nvcc`` for ``sm_90a`` at first use
(``ops/build.py``).
"""

__version__ = "0.2.0"
