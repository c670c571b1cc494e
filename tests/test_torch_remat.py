"""``Remat`` in the port (``models/layers.py::recomputed``): the conv blocks
of the V-Nets and the attention network's heads recomputed in the backward
pass, against JAX's ``nn.remat`` and against the port's plain network, on
the CPU in float32.

* Against JAX (dropout 0; the two frameworks draw other masks): JAX's
  ``remat=True`` network and the port's, from the same converted weights,
  at ``test_models.py``'s 8^3 V-Net, a two-level packed V-Net at 16^3 and a
  2D V-Net at 16^2. Eval logits within 1e-5 of the largest logit (``rtol``
  1e-5); a training step's logits, parameter gradients and running
  averages within 1e-4 of the largest entry of their kind (``rtol`` 1e-4):
  sums in other orders on the two sides. The attention network is
  ``test_torch_attention.py``'s, trained on its loss, its gradients held
  with the backbone's output pinned to JAX's value, as that file explains
  (a ReLU in a head takes the other slope at a pre-activation within
  rounding of 0).
* Against the port's plain network (dropout 0.3 on): the same arithmetic
  in the same order, so the logits, every dropout layer's mask (forward
  and recompute) and the running averages are equal bitwise, and the
  gradients within 1e-5 of the largest (they are equal here too). The
  state dict's keys are the plain network's, and the recompute ran (more
  dropout calls).
* A backward run late and out of context, eval mode and ``torch.export``,
  and the dropout and dW calls a step.

The two-rank cases live in the rank processes of ``test_torch_parallel.py``
(data parallel, backward outside ``data_parallel``) and
``test_torch_spatial.py`` (``SpaceParallel`` 2 through the trainer).
"""

import importlib
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.models.attention import AttentionGatedVNet as JaxAttentionVNet
from vnet_tpu.models.attention import \
    attention_distance_loss as jax_distance_loss
from vnet_tpu.models.vnet import VNet as JaxVNet
from vnet_tpu.ops.losses import segmentation_loss as jax_segmentation_loss
from vnet_tpu_torch import export
from vnet_tpu_torch.convert import (flax_to_state_dict, grads_to_flax,
                                    state_dict_to_flax)
from vnet_tpu_torch.models import (attention_distance_loss, build_network,
                                   eval_apply)
from vnet_tpu_torch.models.layers import Dropout
from vnet_tpu_torch.ops.losses import segmentation_loss

from torch_parity import (assert_logits_close, assert_trees_close,
                          jax_train, port_train, random_variables)

# the modules, not the functions that vnet_tpu_torch.ops re-exports
dropout_ops = importlib.import_module("vnet_tpu_torch.ops.dropout")
dw_ops = importlib.import_module("vnet_tpu_torch.ops.dw_conv")

SMALL = dict(num_classes=2, num_channels=4, num_levels=2,
             num_convolutions=(1, 2), bottom_convolutions=1)
# name: (network, conv_impl, PackedTargetLanes, spatial)
JAX_CASES = {
    "vnet_8": ("VNet", "direct", 0, (8, 8, 8)),
    "packed_16": ("VNet", "packed", 32, (16, 16, 16)),
    "rank2_16": ("VNet", "packed", 16, (16, 16)),
}
PORT_CASES = dict(JAX_CASES, legacy_packed=("VNetLegacy", "packed", 16,
                                            (16, 16, 8)),
                  attention=("AttentionVNet", "packed", 16, (16, 16, 16)))
OUT_RTOL = 1e-5
STEP_RTOL = 1e-4
PLAIN_GRAD_RTOL = 1e-5
LOSS = dict(name="mixed_sorensen", weights=(), alpha=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small networks: one intra-op thread, so that the tests' time does
    not grow with the other test processes' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(case, remat, dropout=0.0, seed=3):
    name, conv_impl, lanes, spatial = PORT_CASES[case]
    heads = {"attention_channels": 8} if name == "AttentionVNet" else {}
    return build_network(name, device="cpu", conv_impl=conv_impl,
                         packed_target_lanes=lanes, dropout_rate=dropout,
                         dropout_impl="pallas", dw_impl="pallas",
                         spatial_rank=len(spatial), remat=remat,
                         generator=torch.Generator().manual_seed(seed),
                         **heads, **SMALL)


def _input(case, rng, batch=2):
    spatial = PORT_CASES[case][3]
    return rng.normal(50.0, 20.0, size=(batch,) + spatial + (1,)).astype(
        np.float32)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_remat_matches_jax_remat(case, rng):
    name, conv_impl, lanes, _ = JAX_CASES[case]
    x = _input(case, rng)
    jnet = jax_build_network(name, conv_impl=conv_impl, remat=True,
                             packed_target_lanes=lanes, dropout_rate=0.0,
                             **SMALL)
    variables = random_variables(jnet, rng, jnp.asarray(x), train=False)
    port = _port(case, remat=True)
    cot = rng.normal(size=x.shape[:-1] + (2,)).astype(np.float32)
    out_ref, grads_ref, stats_ref = jax_train(jnet, variables, x, cot)
    out, grads, stats = port_train(port, variables, x, cot)
    assert_logits_close(out, out_ref, rtol=OUT_RTOL, atol_fraction=OUT_RTOL)
    assert_trees_close(grads, grads_ref, "gradient", rtol=STEP_RTOL,
                       atol_fraction=STEP_RTOL)
    assert_trees_close(stats, stats_ref, "batch_stats", rtol=STEP_RTOL,
                       atol_fraction=STEP_RTOL)


def test_attention_remat_matches_jax_remat():
    """``test_torch_attention.py``'s network (two modalities, heads of 8
    channels, here a packed backbone) with both heads and the backbone's
    blocks recomputed on each side, trained on that file's loss: both
    outputs, every gradient (the backbone's output pinned to JAX's, which
    the same jitted step captures) and the running averages."""
    rng = np.random.default_rng(31)
    x = rng.normal(0.0, 1.0, size=(2, 16, 16, 16, 2)).astype(np.float32)
    labels = rng.integers(0, 2, size=(2, 16, 16, 16)).astype(np.int32)
    dmaps = rng.random(size=(2, 16, 16, 16)).astype(np.float32)
    kw = dict(SMALL, conv_impl="packed", packed_target_lanes=16,
              dropout_rate=0.0, remat=True)
    jnet = JaxAttentionVNet(attention_channels=8, norm="batch", **kw)
    variables = random_variables(jnet, np.random.default_rng(7),
                                 jnp.asarray(x), train=True)
    net = build_network("AttentionVNet", in_channels=2, device="cpu",
                        attention_channels=8, **kw)
    net.load_state_dict(flax_to_state_dict(variables), strict=True)

    def loss(params):
        (out, att), mutated = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "vnet")
        seg, _ = jax_segmentation_loss(out, jnp.asarray(labels),
                                       num_classes=2, **LOSS)
        lv = mutated["intermediates"]["vnet"]["__call__"][0]
        return (seg + jax_distance_loss(att, jnp.asarray(dmaps)),
                (out, att, lv, mutated["batch_stats"]))

    (_, (out_ref, att_ref, lv, stats_ref)), grads_ref = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(variables["params"])
    lv = torch.from_numpy(np.array(lv))
    pin = net.vnet.register_forward_hook(
        lambda module, args, out: lv + (out - out.detach()))
    net.train()
    try:
        out, att = net(torch.from_numpy(x), dropout_seed=0)
        seg, _ = segmentation_loss(out, torch.from_numpy(labels),
                                   num_classes=2, **LOSS)
        (seg + attention_distance_loss(att, torch.from_numpy(dmaps))
         ).backward()
    finally:
        pin.remove()
    for got, r in ((out, out_ref), (att, att_ref)):
        assert_logits_close(got.detach().numpy(), np.asarray(r),
                            rtol=OUT_RTOL, atol_fraction=OUT_RTOL)
    grads = grads_to_flax({k: p.grad for k, p in net.named_parameters()})
    assert_trees_close(grads, jax.device_get(grads_ref), "gradient",
                       rtol=STEP_RTOL, atol_fraction=STEP_RTOL)
    stats = state_dict_to_flax(
        {k: v for k, v in net.state_dict().items()
         if k.endswith(("running_mean", "running_var"))})["batch_stats"]
    assert_trees_close(stats, jax.device_get(stats_ref), "batch_stats",
                       rtol=STEP_RTOL, atol_fraction=STEP_RTOL)


def _masks(net):
    """Forward hooks on every dropout layer: ``(layer index, dropped)`` per
    call, the recompute's calls after the forward's."""
    records = []

    def hook(module, inputs, out):
        records.append((module.index, ((out == 0) & (inputs[0] != 0))))

    return records, [m.register_forward_hook(hook) for m in net.modules()
                     if isinstance(m, Dropout)]


def _step(net, x, cots, seed=1):
    """One training-mode forward at dropout seed ``seed`` and the backward
    of ``sum(out * cot)`` over the outputs: outputs, gradients, state
    dict, the dropout calls' masks."""
    net.train()
    records, handles = _masks(net)
    out = net(torch.from_numpy(x), dropout_seed=seed)
    outs = out if isinstance(out, tuple) else (out,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)
        ).backward()
    for h in handles:
        h.remove()
    return ([o.detach() for o in outs],
            {k: p.grad.clone() for k, p in net.named_parameters()},
            net.state_dict(), records)


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_remat_equals_the_plain_port(case, rng):
    x = _input(case, rng)
    plain, remat = _port(case, False, 0.3), _port(case, True, 0.3)
    assert list(remat.state_dict()) == list(plain.state_dict())
    remat.load_state_dict(plain.state_dict())
    shape = x.shape[:-1] + (2,)
    cots = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    out_p, grads_p, sd_p, masks_p = _step(plain, x, cots)
    out_r, grads_r, sd_r, masks_r = _step(remat, x, cots)
    for a, b in zip(out_r, out_p):
        assert torch.equal(a, b)
    for k, v in sd_p.items():  # running averages moved once, and equal
        assert torch.equal(sd_r[k], v), k
    largest = max(g.abs().max().item() for g in grads_p.values())
    for k, g in grads_p.items():
        err = (grads_r[k] - g).abs().max().item()
        assert err <= PLAIN_GRAD_RTOL * largest, (k, err)
    # the forward's masks are the plain network's; every recomputed
    # layer's mask is its forward's
    n = len(remat.dropouts)
    assert len(masks_p) == n and len(masks_r) > n
    forward = dict(masks_r[:n])
    for (i, m), (j, mp) in zip(masks_r[:n], masks_p):
        assert i == j and torch.equal(m, mp), i
    for i, m in masks_r[n:]:
        assert torch.equal(m, forward[i]), i
    assert any(m.any() for _, m in masks_p)


def test_a_late_backward_out_of_train_mode_equals_the_plain_one(rng):
    """Forward at seed 1, a second forward at seed 2, the network put in
    eval mode, then the first forward's backward: the recompute runs at
    seed 1 in train mode, so its gradients and running averages are the
    plain network's for the forward at seed 1 alone; the second backward
    then gives the seed-2 step's."""
    x = _input("packed_16", rng)
    cot = rng.normal(size=x.shape[:-1] + (2,)).astype(np.float32)
    plain, remat = _port("packed_16", False, 0.3), _port("packed_16", True,
                                                           0.3)
    remat.train()
    first = (remat(torch.from_numpy(x), dropout_seed=1)
             * torch.from_numpy(cot)).sum()
    second = (remat(torch.from_numpy(x[::-1].copy()), dropout_seed=2)
              * torch.from_numpy(cot)).sum()
    remat.eval()
    first.backward()
    assert not remat.training and all(m.seed == 2 for m in remat.dropouts)
    _, grads, _, _ = _step(plain, x, [cot], seed=1)
    for k, p in remat.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    remat.zero_grad(set_to_none=True)
    second.backward()
    plain.zero_grad(set_to_none=True)
    _, grads, _, _ = _step(plain, x[::-1].copy(), [cot], seed=2)
    for k, p in remat.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    for k, v in plain.state_dict().items():
        assert torch.equal(remat.state_dict()[k], v), k


def test_a_second_backward_over_a_retained_graph_recomputes_again(rng):
    """``backward(retain_graph=True)`` then a second backward over the same
    graph: each backward recomputes the blocks under what the forward saw
    (dropout seed 1, train mode), so both give the plain network's
    gradients, every recomputed mask is the forward's, and the running
    averages moved once."""
    x = _input("packed_16", rng)
    cot = rng.normal(size=x.shape[:-1] + (2,)).astype(np.float32)
    plain, remat = _port("packed_16", False, 0.3), _port("packed_16", True,
                                                           0.3)
    _, grads, sd, _ = _step(plain, x, [cot], seed=1)
    remat.train()
    records, handles = _masks(remat)
    loss = (remat(torch.from_numpy(x), dropout_seed=1)
            * torch.from_numpy(cot)).sum()
    n = len(records)
    remat.eval()
    for retain in (True, False):
        remat.zero_grad(set_to_none=True)
        loss.backward(retain_graph=retain)
        for k, p in remat.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), grads[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
    for h in handles:
        h.remove()
    assert not remat.training
    recomputed = records[n:]  # the first backward's, then the second's
    half = len(recomputed) // 2
    assert half and len(recomputed) == 2 * half
    assert [i for i, _ in recomputed[:half]] == [i for i, _ in
                                                 recomputed[half:]]
    forward = dict(records[:n])
    for i, m in recomputed:
        assert torch.equal(m, forward[i]), i
    for k, v in sd.items():
        assert torch.equal(remat.state_dict()[k], v), k


def test_eval_and_export_are_the_plain_network(rng):
    """In eval mode a ``Remat`` network runs as the plain one: the same
    logits bitwise, and ``torch.export`` gives the same program."""
    plain, remat = _port("packed_16", False), _port("packed_16", True)
    x = torch.from_numpy(_input("packed_16", rng, batch=1))
    assert torch.equal(eval_apply(remat, x), eval_apply(plain, x))
    texts = [export.graph_text(n, tuple(x.shape), device="cpu")
             for n in (remat, plain)]
    assert texts[0] == texts[1]


@pytest.mark.parametrize("case", ["packed_16", "vnet_8"])
def test_remat_recomputes_dropout_but_not_dw(case, monkeypatch):
    """With ``Remat`` the dW calls of a step are the plain step's, at the
    same shapes, and dropout runs the plain step's ``2 n`` times plus the
    recompute of every layer that is not its block's last (a block's
    output is its last dropout's, which nothing inside the block keeps, so
    the recompute stops before it): 14 + 2 for these 7 layers in 5 blocks
    (the flagship: 42 + 12, held on the card by ``chip_smoke.py``)."""
    calls = {"dw": [], "dropout": []}
    real_dw, real_drop = dw_ops.dw_conv, dropout_ops.dropout_apply

    def dw(x, g, ks):
        calls["dw"].append((tuple(x.shape), tuple(ks)))
        return real_dw(x, g, ks)

    def drop(x, *args):
        calls["dropout"].append(tuple(x.shape))
        return real_drop(x, *args)

    monkeypatch.setattr(dw_ops, "dw_conv", dw)
    monkeypatch.setattr(dropout_ops, "dropout_apply", drop)
    x = torch.from_numpy(_input(case, np.random.default_rng(0), batch=1))
    counted = {}
    for remat in (False, True):
        net = _port(case, remat, dropout=0.3)
        net.train()
        net(x, dropout_seed=1).sum().backward()
        counted[remat] = {k: Counter(v) for k, v in calls.items()}
        for v in calls.values():
            v.clear()
    assert len(net.dropouts) == 7
    assert sum(counted[False]["dropout"].values()) == 14
    assert sum(counted[True]["dropout"].values()) == 16
    assert counted[True]["dw"] == counted[False]["dw"]
    assert sum(counted[True]["dw"].values()) > 0
