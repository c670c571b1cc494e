"""The port's packed V-Net against the JAX package's, and against its own
direct V-Net, on the CPU in float32.

Same numpy input, same variables (``convert.py``), dropout 0. Widths and
``PackedTargetLanes`` are chosen so that every per-axis factor combination
of the adaptive mode ((2,2,2), (2,2,1), (2,1,1) in 3D; (2,2), (2,1) in 2D)
and an unpacked level occur, plus ``PackedTargetLanes: 0`` (every level
packed on all axes). Sums run in another order on each side: logits are
held at ``atol = rtol = 1e-4`` relative to the largest logit; parameter
gradients and running averages at ``rtol = 1e-4`` and ``atol = 1e-4`` of
the largest entry of their kind (a conv bias ahead of a batch norm has a
gradient that is zero up to rounding). The shipped configs' level plans
are held to the JAX module's own decisions, and a training step at full
width counts the dW and dropout launches of the packed flagship.
"""

import importlib
import math
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.models.vnet import adaptive_factors as jax_adaptive_factors
from vnet_tpu_torch.config import load_config
from vnet_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from vnet_tpu_torch.models import build_network, eval_apply

from torch_parity import (assert_logits_close, assert_trees_close,
                          jax_train, port_train, random_variables)

# the modules, not the functions that vnet_tpu_torch.ops re-exports
dw_ops = importlib.import_module("vnet_tpu_torch.ops.dw_conv")
dropout_ops = importlib.import_module("vnet_tpu_torch.ops.dropout")
ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(num_classes=3, num_channels=4, num_levels=2,
             num_convolutions=(1, 2), bottom_convolutions=1,
             dropout_rate=0.0)


# (name, PackedTargetLanes, spatial, plan of the encoder levels and bottom)
CASES = [
    ("VNet", 32, (16, 16, 16), [(2, 2, 2), (2, 2, 1), (2, 1, 1)]),
    ("VNet", 16, (16, 16, 12), [(2, 2, 1), (2, 1, 1), None]),
    ("VNet", 0, (16, 16, 16), [(2, 2, 2), (2, 2, 2), (2, 2, 2)]),
    ("VNet", 16, (16, 16), [(2, 2), (2, 1), None]),
    # an odd extent keeps the bottom (4, 3) unpacked under full packing
    ("VNet", 0, (16, 12), [(2, 2), (2, 2), None]),
]


def _case(name, lanes, spatial, rng, in_channels=1):
    x = rng.normal(50.0, 20.0, size=(2,) + spatial + (in_channels,)
                   ).astype(np.float32)
    jnet = jax_build_network(name, packed_target_lanes=lanes, **SMALL)
    variables = random_variables(jnet, rng, jnp.asarray(x), train=False)
    port = build_network(name, in_channels=in_channels, device="cpu",
                         packed_target_lanes=lanes,
                         spatial_rank=len(spatial), **SMALL)
    return x, jnet, variables, port


@pytest.mark.parametrize("name,lanes,spatial,levels", CASES, ids=str)
def test_packed_vnet_eval_and_train_equal_jax(name, lanes, spatial, levels,
                                              rng):
    x, jnet, variables, port = _case(name, lanes, spatial, rng)
    plan = port.plan(spatial)
    got = [f if p else None for p, f in plan["encoder"] + [plan["bottom"]]]
    assert got == levels

    ref = np.asarray(jnet.apply(variables, jnp.asarray(x), train=False))
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert_logits_close(eval_apply(port, torch.from_numpy(x)).numpy(), ref)

    cot = rng.normal(size=ref.shape).astype(np.float32)
    out_ref, grads_ref, stats_ref = jax_train(jnet, variables, x, cot)
    out, grads, stats = port_train(port, variables, x, cot)
    assert_logits_close(out, out_ref)
    assert_trees_close(grads, grads_ref, "gradient")
    assert_trees_close(stats, stats_ref, "batch_stats")


@pytest.mark.parametrize("spatial,in_channels,dw_impl", [
    ((16, 16, 16), 1, "pallas"), ((16, 16, 16), 2, "custom"),
    ((16, 16), 1, "xla")], ids=str)
def test_packed_equals_direct_in_the_port(spatial, in_channels, dw_impl,
                                          rng):
    """The same weights through both computations: logits, every
    gradient and the running averages of a training step."""
    x = rng.normal(50.0, 20.0, size=(2,) + spatial + (in_channels,)
                   ).astype(np.float32)
    kw = dict(SMALL, in_channels=in_channels, device="cpu", dw_impl=dw_impl,
              spatial_rank=len(spatial), packed_target_lanes=16,
              generator=torch.Generator().manual_seed(3))
    packed = build_network("VNet", **kw)
    direct = build_network("VNet", conv_impl="direct", **kw)
    variables = state_dict_to_flax(packed.state_dict())
    cot = rng.normal(size=x.shape[:-1] + (3,)).astype(np.float32)
    out_d, grads_d, stats_d = port_train(direct, variables, x, cot)
    out_p, grads_p, stats_p = port_train(packed, variables, x, cot)
    assert_logits_close(out_p, out_d)
    assert_trees_close(grads_p, grads_d, "gradient")
    assert_trees_close(stats_p, stats_d, "batch_stats")


def _config_network(name):
    t = load_config(str(ROOT / "configs" / name)).train
    n = t.network
    net = build_network(n.name, num_classes=t.num_classes,
                        in_channels=t.input_channels, dropout_rate=n.dropout,
                        num_channels=n.num_channel, num_levels=n.num_levels,
                        num_convolutions=n.num_convolutions,
                        bottom_convolutions=n.bottom_convolutions,
                        norm=n.norm,
                        packed_target_lanes=n.packed_target_lanes,
                        dtype=torch.bfloat16, device="meta",
                        spatial_rank=t.dimension)
    return net, t


@pytest.mark.parametrize("config,patch,expect", [
    # level: (grid, channels, factors); the packed tensor is (B, 128, grid/f)
    # at bench.py's flagship patch, 64^3
    ("config.json", (64, 64, 64), [
        ((64, 64, 64), 16, (2, 2, 2)), ((32, 32, 32), 32, (2, 2, 1)),
        ((16, 16, 16), 64, (2, 1, 1)), ((8, 8, 8), 128, None),
        ((4, 4, 4), 256, None)]),
    # 2D: adaptive_factors packs both axes of a 2-D grid at 16 channels
    # (64 lanes, the most two axes reach)
    ("config_2d.json", (256, 256), [
        ((256, 256), 16, (2, 2)), ((128, 128), 32, (2, 2)),
        ((64, 64), 64, (2, 1)), ((32, 32), 128, None),
        ((16, 16), 256, None)])], ids=["3d", "2d"])
def test_shipped_configs_build_the_packed_flagship(config, patch, expect):
    net, t = _config_network(config)
    assert net.conv_impl == "packed" and net.packed_target_lanes == 128
    plan = net.plan(patch)
    levels = plan["encoder"] + [plan["bottom"]]
    for (grid, ch, factors), (ok, f) in zip(expect, levels):
        assert jax_adaptive_factors(grid, ch, 128) == (ok, f)
        assert (f if ok else None) == factors
        if ok:
            assert math.prod(f) * ch == min(128, 2 ** len(grid) * ch)
    assert plan["decoder"] == plan["encoder"]
    # the dropout inputs of the packed network (meta device)
    seen = []
    from vnet_tpu_torch.models.layers import Dropout
    for m in net.modules():
        if isinstance(m, Dropout):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append(tuple(args[0].shape[1:])))
    net.eval()
    with torch.no_grad():
        net(torch.zeros((1,) + patch + (t.input_channels,), device="meta"))
    if config == "config.json":
        assert Counter(seen) == Counter({
            (128, 32, 32, 32): 2, (128, 16, 16, 32): 4,
            (128, 8, 16, 16): 6, (128, 8, 8, 8): 6, (256, 4, 4, 4): 3})


def test_full_packing_packs_to_the_cap_at_full_width():
    """``PackedTargetLanes: 0``: every level whose 2^3 x channels (decoder:
    twice them) is within 1024 packs all three axes — 8^3 at 128 channels
    (1024 packed channels) too; the 256-channel bottom stays direct."""
    net = build_network("VNet", num_classes=3, device="meta",
                        packed_target_lanes=0)
    plan = net.plan((64, 64, 64))
    full = (True, (2, 2, 2))
    assert plan["encoder"] == [full] * 4 and plan["decoder"] == [full] * 4
    assert plan["bottom"] == (False, None)
    # the JAX rule, by hand: 8 * ch <= 1024 (decoder 8 * 2ch <= 2048)
    assert 8 * 128 == 1024 and 8 * 256 > 1024


def test_flagship_step_launches_21_dw_and_42_dropout(monkeypatch):
    """A training step of the flagship network (full width, DwImpl and
    DropoutImpl ``pallas``) at a 16^3 patch, batch 1: the plan has the
    64^3 one's shape (levels 0-2 packed, 3 and the bottom direct), so the
    step launches the dW wrapper 21 times at 9 distinct shapes (the 1^3
    output conv is a grouped product) and dropout 42 times."""
    dw_calls, drop_calls = [], []
    real_dw, real_drop = dw_ops.dw_conv, dropout_ops.dropout_apply

    def dw(x, g, ks):
        dw_calls.append((tuple(x.shape[1:]), g.shape[1], tuple(ks)))
        return real_dw(x, g, ks)

    def drop(x, *args):
        drop_calls.append(tuple(x.shape))
        return real_drop(x, *args)

    monkeypatch.setattr(dw_ops, "dw_conv", dw)
    monkeypatch.setattr(dropout_ops, "dropout_apply", drop)
    net = build_network("VNet", num_classes=3, device="cpu",
                        dropout_impl="pallas", dw_impl="pallas",
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 16, 16, 16, 1)
    net.train()
    net(x, dropout_seed=1).sum().backward()
    assert len(dw_calls) == 21 and len(set(dw_calls)) == 9
    kernels = Counter(k for _, _, k in dw_calls)
    assert kernels == Counter({(3, 3, 3): 2, (3, 3, 5): 4, (3, 5, 5): 6,
                               (5, 5, 5): 9})
    splices = {c for c in dw_calls if c[0][0] == 2 * c[1]}
    assert len(splices) == 4  # the three packed decoder splices and 8^3's
    assert len(drop_calls) == 42


def test_dw_bench_takes_its_shapes_from_the_module_tree():
    """``tools/dw_bench.py`` lists the flagship step's weight gradients from
    the built network: nine shapes and 21 launches packed, the direct
    network's ten and 22 (the table it held before it read module trees).
    """
    from vnet_tpu_torch.tools.dw_bench import dw_shapes

    packed = dw_shapes("packed")
    assert len(packed) == 9 and sum(s[-1] for s in packed) == 21
    assert ((256, 128, (32, 32, 32), (3, 3, 3), 1) in packed
            and (128, 128, (16, 16, 32), (3, 3, 5), 3) in packed
            and (256, 128, (8, 16, 16), (3, 5, 5), 1) in packed)
    direct = {(ci, co, vol[0], ks[0], n)
              for ci, co, vol, ks, n in dw_shapes("direct")}
    assert direct == {
        (16, 16, 64, 5, 1), (32, 16, 64, 5, 1), (32, 32, 32, 5, 3),
        (64, 32, 32, 5, 1), (64, 64, 16, 5, 5), (128, 64, 16, 5, 1),
        (128, 128, 8, 5, 5), (256, 128, 8, 5, 1), (256, 256, 4, 5, 3),
        (16, 3, 64, 1, 1)}


@pytest.mark.parametrize("factors,keep", [
    ((2, 2, 1), False), ((2, 2, 2), True), ((2, 1), False)], ids=str)
def test_packed_down_and_up_conv_modules_equal_jax(factors, keep, rng):
    """``DownConv(packed_input, packed_factors, packed_output)`` and
    ``UpConv(packed_output, packed_factors)``, norms and activations in the
    packed domain, eval mode."""
    from vnet_tpu.models import layers as jl
    from vnet_tpu.ops.s2d import prod_factors as jax_prod
    from vnet_tpu_torch.models import layers as tl
    from torch_parity import from_port, jax_apply, to_port

    rank = len(factors)
    g = jax_prod(factors)
    xp = rng.normal(size=(2,) + tuple(8 // f for f in factors)
                    + (g * 4,)).astype(np.float32)
    down = jl.DownConv(2, "batch", "prelu", packed_input=True,
                       packed_factors=factors, packed_output=keep)
    v = random_variables(down, rng, jnp.asarray(xp), train=False)
    ref = jax_apply(down, v, jnp.asarray(xp), train=False)
    port = tl.DownConv(4, 2, "batch", "prelu", rank=rank, impl="auto")
    port.load_state_dict(flax_to_state_dict(v), strict=True)
    port.eval()
    with torch.no_grad():
        out = from_port(port(to_port(xp), packed_input=True,
                             packed_factors=factors, packed_output=keep))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    x = rng.normal(size=(2,) + (4,) * rank + (8,)).astype(np.float32)
    up = jl.UpConv(2, "batch", "prelu", packed_output=True,
                   packed_factors=factors)
    v = random_variables(up, rng, jnp.asarray(x), train=False)
    ref = jax_apply(up, v, jnp.asarray(x), train=False)
    port = tl.UpConv(8, 2, "batch", "prelu", rank=rank, impl="auto")
    port.load_state_dict(flax_to_state_dict(v), strict=True)
    port.eval()
    with torch.no_grad():
        out = from_port(port(to_port(x), packed_output=True,
                             packed_factors=factors))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
