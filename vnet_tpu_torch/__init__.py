"""vnet_tpu_torch — the PyTorch / CUDA port of ``vnet_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference: every
module here is tested against its ``vnet_tpu`` counterpart on the same
inputs and weights (``tests/test_torch_*.py``). It imports ``torch`` and
never ``jax``, and nothing of ``vnet_tpu``: the host modules it needs are
its own copies, laid out as in the JAX package (``config``, ``io``, the 3D
part of ``data``).

Two slices run on the card: 3D training (``python -m vnet_tpu_torch -p
train --config_json F --device cuda``; V-Net or the attention-gated V-Net,
on-device augmentation, TensorBoard event files and image logs, traces),
with dropout and the weight gradient of the stride-1 convolutions as
hand-written CUDA kernels (``csrc/dropout.cu``, ``csrc/dw_conv.cu``), and
whole-volume 3D evaluation (``-p evaluate``), with the sliding-window blend
as one (``csrc/blend_accumulate.cu``). The networks are JAX's zoo (VNet,
VNetLegacy, UNet, Dense, AttentionVNet), built as JAX's trainer builds
them: the V-Nets' convolutions packed by space-to-depth (``ops/s2d.py``)
unless ``conv_impl="direct"`` is asked for. Convolutions otherwise run
through cuDNN, the packed network's strided ones as matrix products.
Kernels are built with ``nvcc`` for ``sm_90a`` at first use
(``ops/build.py``).

Beside the main command line: the quickstart (``python -m
vnet_tpu_torch.quickstart``: synthetic data, training, evaluation, Dice),
the legacy flag command lines (``flags.train``, ``flags.evaluate``), the
attention quality run (``experiments.attn_quality``) and the host
utilities (``utils.batch_evaluate``, ``utils.bbox``,
``utils.prepare_data``), each the counterpart of a JAX-package script.
"""

__version__ = "0.2.0"
