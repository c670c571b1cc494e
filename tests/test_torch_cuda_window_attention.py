"""The shifted-window attention kernels (``csrc/window_attention.cu``,
``ops/window_attention.py``) on the card: each checked shape of
``tools/wattn_bench.py`` (stage 1 of a batch of 2 96^3 patches, shifted
and not; stage 4's 216-token window) against the plain version, with the
tolerances stated there; and a SwinUNETR training step at 96^3 in bf16:
every attention call on the kernels (per step, under ``Remat``, 16 forward
launches, the forward and the recompute of 8 blocks, 8 backward and 8
bias-gradient calls), finite loss and gradients, and a CUDA tensor that
is not bf16 refused.

JAX-free, so the card's machine runs it: ``python -m pytest --noconftest
-m cuda -q tests/test_torch_cuda_*.py``. Without a card every test skips.
"""

import pytest
import torch

from vnet_tpu_torch.models import build_network
from vnet_tpu_torch.ops import window_attention as wa
from vnet_tpu_torch.tools import wattn_bench


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(wattn_bench.CHECKS))
def test_kernels_match_plain(case, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    wattn_bench.check_call(wattn_bench.CHECKS[case], gen)
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_training_step_runs_on_the_kernels(cuda_device):
    torch.manual_seed(0)
    net = build_network("SwinUNETR", num_classes=14, num_channels=48,
                        dropout_rate=0.0, dtype=torch.bfloat16,
                        device=cuda_device, remat=True)
    net.train()
    x = torch.randn(1, 96, 96, 96, 1, device=cuda_device)
    counters = (wa.window_attention_fwd, wa.window_attention_bwd,
                wa.window_attention_dbias)
    before = [f.launches for f in counters]
    logits = net(x)
    logits.float().square().mean().backward()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [16, 8, 8]
    assert torch.isfinite(logits).all()
    for name, p in net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    qkv = torch.zeros(2, 8, 3 * 16, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        wa.window_attention(qkv, 1, torch.zeros(13 ** 3, 1,
                                                device=cuda_device),
                            torch.zeros(8, 8, dtype=torch.long,
                                        device=cuda_device))
