"""The port's attention-gated V-Net (``models/attention.py``) against the
JAX package's.

Same numpy inputs and converted variables on both sides, float32, a
4-channel 2-level backbone with attention heads of 8 channels, 16^3 patches
of two modalities, dropout 0. Forward outputs, losses and gradients agree
to ``rtol = 1e-4`` and ``atol = 1e-5`` times the largest entry of their
kind, tensor by tensor: sums run in another order on each side, and each
batch norm scales those differences by ``1 / std`` (entries near 0 carry
the absolute part, as in ``test_torch_trainer.py``). The backbone's logits
differ by about 1e-5 of their scale, and a voxel whose pre-activation in
a ReLU head lies that close to 0 takes the other slope on one side only;
the batch norms that follow spread that over every backbone gradient (0.7%
of each). So the whole-network gradients, and the training step's
updates, are taken with the port's backbone output pinned to the JAX
backbone's value (``lv + (out - out.detach())``: JAX's numbers forward,
the port's backbone in the backward): the port's forward as written, the
gate and both heads then run on the same inputs as JAX's. Each head alone,
and the backbone's vector-Jacobian product, are held from identical inputs
too. The distance loss agrees to ``rtol = 1e-6``. One training step of the
port's trainer against the JAX trainer's ``make_train_step`` with the
attention loss, and the ``convert.py`` round trip of the attention tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnet_tpu.config import LossConfig as JaxLossConfig
from vnet_tpu.models.attention import AttentionGatedVNet as JaxAttentionVNet
from vnet_tpu.models.attention import AttentionModule as JaxAttentionModule
from vnet_tpu.models.attention import OutputModule as JaxOutputModule
from vnet_tpu.models.attention import \
    attention_distance_loss as jax_distance_loss
from vnet_tpu.models.vnet import VNet as JaxVNet
from vnet_tpu.ops.losses import segmentation_loss as jax_segmentation_loss
from vnet_tpu.train.trainer import TrainState as JaxTrainState
from vnet_tpu.train.trainer import make_train_step as jax_make_train_step
from vnet_tpu_torch.config import LossConfig, OptimizerConfig
from vnet_tpu_torch.convert import (flax_to_state_dict, grads_to_flax,
                                    state_dict_to_flax)
from vnet_tpu_torch.models import (AttentionModule, OutputModule,
                                   attention_distance_loss, build_network,
                                   eval_apply)
from vnet_tpu_torch.ops.losses import segmentation_loss
from vnet_tpu_torch.train import TrainState, make_train_step
from vnet_tpu_torch.train.optim import build_optimizer

from torch_parity import random_variables

RTOL, ATOL = 1e-4, 1e-5
BACKBONE = dict(num_classes=2, num_channels=4, num_levels=2,
                num_convolutions=(1, 2), bottom_convolutions=1,
                dropout_rate=0.0)
NET = dict(BACKBONE, attention_channels=8, norm="batch")
LOSS = dict(name="mixed_sorensen", weights=(), alpha=0.5)
HEADS = {"attention": (JaxAttentionModule, AttentionModule),
         "output_module": (JaxOutputModule, OutputModule)}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _close(got, ref, err_msg=""):
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL * np.abs(ref).max(),
                               err_msg=err_msg)


def _assert_trees_close(got, ref, what):
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys(), what
    atol = ATOL * max(np.abs(v).max() for v in ref.values())
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(31)
    images = rng.normal(0.0, 1.0, size=(2, 16, 16, 16, 2)).astype(np.float32)
    labels = rng.integers(0, 2, size=(2, 16, 16, 16)).astype(np.int32)
    dmaps = rng.random(size=(2, 16, 16, 16)).astype(np.float32)
    return images, labels, dmaps


@pytest.fixture(scope="module")
def pair(batch):
    images = batch[0]
    jnet = JaxAttentionVNet(conv_impl="direct", **NET)
    variables = random_variables(jnet, np.random.default_rng(7),
                                 jnp.asarray(images), train=True)
    net = build_network("AttentionVNet", in_channels=2, device="cpu", **NET)
    net.load_state_dict(flax_to_state_dict(variables))
    return jnet, variables, net


def _jax_forward(jnet, variables, images, train):
    out, _ = jnet.apply(variables, jnp.asarray(images), train=train,
                        mutable=["batch_stats"])
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_matches_jax(head, train, batch):
    jax_cls, port_cls = HEADS[head]
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 16, 2)).astype(
        np.float32)
    jmod = jax_cls(2, 8)
    variables = random_variables(jmod, np.random.default_rng(4),
                                 jnp.asarray(x), train=True)
    ref, _ = jmod.apply(variables, jnp.asarray(x), train=train,
                        mutable=["batch_stats"])
    mod = port_cls(2, 2, num_channels=8)
    mod.load_state_dict(flax_to_state_dict(variables))
    mod.train(train)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("train", [True, False])
def test_network_forward_matches_jax(train, pair, batch):
    jnet, variables, net = pair
    images = batch[0]
    ref = _jax_forward(jnet, variables, images, train)
    if train:
        net.train()
        with torch.no_grad():
            got = net(torch.from_numpy(images), dropout_seed=0)
        net.load_state_dict(flax_to_state_dict(variables))  # undo the EMA
    else:
        got = eval_apply(net, torch.from_numpy(images))
    assert len(got) == 2
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 16, 16, 16, 2)
        _close(g.numpy(), r)


def _jax_backbone(variables, images):
    """The JAX backbone's train-mode logits, and the function itself."""
    jvnet = JaxVNet(conv_impl="direct", **BACKBONE)

    def apply(p):
        out, _ = jvnet.apply(
            {"params": p, "batch_stats": variables["batch_stats"]["vnet"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        return out

    return apply(variables["params"]["vnet"]), apply


def _pin_backbone(net, variables, images):
    """Make the port's backbone return the JAX backbone's logits, value
    for value, with its own gradient: a forward hook on ``net.vnet``;
    returns the handle."""
    lv = torch.from_numpy(np.array(_jax_backbone(variables, images)[0]))
    return net.vnet.register_forward_hook(
        lambda module, args, out: lv + (out - out.detach()))


def _port_loss(logits, att, labels, dmaps):
    seg, _ = segmentation_loss(logits, torch.from_numpy(labels),
                               num_classes=2, **LOSS)
    return seg + attention_distance_loss(att, torch.from_numpy(dmaps))


def _jax_loss(logits, att, labels, dmaps):
    seg, _ = jax_segmentation_loss(logits, jnp.asarray(labels),
                                   num_classes=2, **LOSS)
    return seg + jax_distance_loss(att, jnp.asarray(dmaps))


def test_heads_and_gate_gradients_match_jax(pair, batch):
    """Both heads, the gate and both losses from the same backbone logits:
    the gradients of every head parameter and of the logits."""
    _, variables, net = pair
    _, labels, dmaps = batch
    params, stats = variables["params"], variables["batch_stats"]
    lv = (np.random.default_rng(5).normal(size=(2, 16, 16, 16, 2)) * 3.0
          ).astype(np.float32)

    def heads(p, lv):
        att, _ = JaxAttentionModule(2, 8).apply(
            {"params": p["attention"], "batch_stats": stats["attention"]},
            lv, train=True, mutable=["batch_stats"])
        out, _ = JaxOutputModule(2, 8).apply(
            {"params": p["output_module"],
             "batch_stats": stats["output_module"]},
            (1.0 + jax.nn.softmax(att, axis=-1)) * lv, train=True,
            mutable=["batch_stats"])
        return _jax_loss(out, att, labels, dmaps)

    head_params = {k: params[k] for k in ("attention", "output_module")}
    jloss, (jgrads, jglv) = jax.value_and_grad(heads, argnums=(0, 1))(
        head_params, jnp.asarray(lv))
    net.train()
    net.zero_grad(set_to_none=True)
    lvt = torch.from_numpy(lv).requires_grad_()
    att = net.attention(lvt)
    out = net.output_module((1.0 + torch.softmax(att, dim=-1)) * lvt)
    loss = _port_loss(out, att, labels, dmaps)
    loss.backward()
    net.load_state_dict(flax_to_state_dict(variables))  # undo the EMA
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    _close(lvt.grad.numpy(), np.asarray(jglv))
    grads = grads_to_flax({k: p.grad for k, p in net.named_parameters()
                           if not k.startswith("vnet.")})
    _assert_trees_close(grads, jax.device_get(jgrads), "gradient")


def test_backbone_vjp_matches_jax(pair, batch):
    """The backbone's parameter gradients of ``sum(logits * w)``: with the
    heads' test above, every factor of the whole network's chain rule."""
    _, variables, net = pair
    images = batch[0]
    w = np.random.default_rng(6).normal(size=(2, 16, 16, 16, 2)).astype(
        np.float32)
    apply = _jax_backbone(variables, images)[1]
    jgrads = jax.grad(lambda p: jnp.sum(apply(p) * w))(
        variables["params"]["vnet"])
    net.train()
    net.zero_grad(set_to_none=True)
    out = net.vnet(torch.from_numpy(images), dropout_seed=0)
    (out * torch.from_numpy(w)).sum().backward()
    net.load_state_dict(flax_to_state_dict(variables))  # undo the EMA
    grads = grads_to_flax({k: p.grad for k, p in net.named_parameters()
                           if k.startswith("vnet.")})["vnet"]
    _assert_trees_close(grads, jax.device_get(jgrads), "gradient")


def test_network_loss_and_gradients_match_jax(pair, batch):
    """The loss through ``AttentionGatedVNet.forward``, then every
    parameter's gradient, with the backbone output pinned to JAX's."""
    jnet, variables, net = pair
    images, labels, dmaps = batch

    def loss_fn(params):
        (logits, att), _ = jnet.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        return _jax_loss(logits, att, labels, dmaps)

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    net.train()
    with torch.no_grad():
        loss = _port_loss(*net(torch.from_numpy(images), dropout_seed=0),
                          labels, dmaps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    net.zero_grad(set_to_none=True)
    pin = _pin_backbone(net, variables, images)
    try:
        loss = _port_loss(*net(torch.from_numpy(images), dropout_seed=0),
                          labels, dmaps)
        loss.backward()
    finally:
        pin.remove()
        net.load_state_dict(flax_to_state_dict(variables))  # undo the EMA
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    grads = grads_to_flax({k: p.grad for k, p in net.named_parameters()})
    _assert_trees_close(grads, jax.device_get(jgrads), "gradient")


@pytest.mark.parametrize("with_class_axis", [False, True])
@pytest.mark.parametrize("kind", ["l2", "abs"])
def test_distance_loss_matches_jax(kind, with_class_axis, rng):
    att = rng.normal(size=(2, 6, 5, 4, 3)).astype(np.float32)
    shape = att.shape if with_class_axis else att.shape[:-1]
    dmap = rng.random(size=shape).astype(np.float32)
    ref = jax_distance_loss(jnp.asarray(att), jnp.asarray(dmap), kind=kind,
                            scale=37.0)
    got = attention_distance_loss(torch.from_numpy(att),
                                  torch.from_numpy(dmap), kind=kind,
                                  scale=37.0)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="attention loss kind"):
        attention_distance_loss(torch.from_numpy(att),
                                torch.from_numpy(dmap), kind="huber")


def test_train_step_matches_jax_trainer(pair, batch):
    """One SGD step through each trainer's step function: loss, the
    attention loss in ``aux``, the metrics and the updated parameters
    (the port's backbone output pinned to JAX's, as above)."""
    jnet, variables, _ = pair
    images, labels, dmaps = batch
    lr = 0.05
    loss_kw = dict(LOSS, attention_kind="l2", attention_scale=100.0)
    tx = optax.sgd(lr)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32),
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]))
    jstep = jax.jit(jax_make_train_step(jnet, tx, JaxLossConfig(**loss_kw),
                                        2, is_attention=True))
    jstate, jloss, jaux, jmetrics = jstep(
        jstate, jnp.asarray(images), jnp.asarray(labels),
        jax.random.PRNGKey(0), jnp.asarray(dmaps))

    net = build_network("AttentionVNet", in_channels=2, device="cpu", **NET)
    net.load_state_dict(flax_to_state_dict(variables))
    opt, schedule = build_optimizer(
        OptimizerConfig(name="SGD", initial_learning_rate=lr,
                        decay_factor=1.0), net.parameters())
    step = make_train_step(LossConfig(**loss_kw), 2, schedule,
                           is_attention=True)
    state = TrainState(net, opt)
    pin = _pin_backbone(net, variables, images)
    try:
        out = step(state, torch.from_numpy(images), torch.from_numpy(labels),
                   0, torch.from_numpy(dmaps))
    finally:
        pin.remove()
    assert state.step == 1
    np.testing.assert_allclose(out.loss.item(), float(jloss), rtol=RTOL)
    assert set(out.aux) == set(jaux)
    for k in ("attention_loss", "total_loss"):
        np.testing.assert_allclose(out.aux[k].item(), float(jaux[k]),
                                   rtol=RTOL)
    assert set(out.metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(out.metrics[k].item(), float(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # the updates are -lr times the gradients, held as in the test above
    before = variables["params"]
    update = {k: p.detach() - flax_to_state_dict({"params": before})[k]
              for k, p in net.named_parameters()}
    jupdate = jax.tree_util.tree_map(lambda a, b: np.asarray(a - b),
                                     jax.device_get(jstate.params), before)
    _assert_trees_close(state_dict_to_flax(update)["params"], jupdate,
                        "update")


def test_convert_round_trip_of_the_attention_tree(pair):
    """flax -> port -> flax gives the JAX tree back, path for path (both
    collections), and the port's names cover every flax variable."""
    _, variables, net = pair
    back = state_dict_to_flax(net.state_dict())
    for collection in ("params", "batch_stats"):
        ref = dict(_flat(variables[collection]))
        got = dict(_flat(back[collection]))
        assert got.keys() == ref.keys(), collection
        for key, value in ref.items():
            np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    assert {p[0] for p in dict(_flat(back["params"]))} == {
        "vnet", "attention", "output_module"}
    again = flax_to_state_dict(back)
    for k, v in net.state_dict().items():
        assert torch.equal(again[k], v), k


def test_dropout_layers_have_their_own_streams():
    net = build_network("AttentionVNet", in_channels=2, device="cpu",
                        **dict(NET, dropout_rate=0.1))
    # backbone: 1 + 2 encoder, 1 bottom, 2 + 1 decoder; heads: 3 blocks x 2
    assert [m.index for m in net.dropouts] == list(range(7 + 12))
    assert net.dropouts[:7] == net.vnet.dropouts
    net.train()
    logits, att = net(torch.zeros(1, 16, 16, 16, 2), dropout_seed=4)
    assert all(m.seed == 4 for m in net.dropouts)
    assert logits.dtype == att.dtype == torch.float32
