"""The port's export (``vnet_tpu_torch/export.py``) against the JAX
package's (``vnet_tpu/export.py``), on the CPU in float32.

Same numpy input, same variables (``convert.py``). The port's
``load_exported(export_forward(...))`` is held to JAX's
``load_exported(export_forward(...))`` at ``atol = 1e-5`` (the bound of
JAX's own ``tests/test_export.py``) for ``test_export.py``'s VNet at 8^3, a
two-level packed VNet (factors (2, 2, 1) and (2, 1, 1), an unpacked
bottom), a small ``AttentionVNet`` (its refined output) and ``Norm:
batch_stats`` (the batch's own statistics). One AOTInductor package for the
CPU, written by ``python -m vnet_tpu_torch.export``'s ``main`` from a tiny
checkpoint (the file's one Inductor compile, shared by a module fixture),
gives JAX's probabilities at the same bound.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnet_tpu.export import export_forward as jax_export_forward
from vnet_tpu.export import load_exported as jax_load_exported
from vnet_tpu.models import VNet as JaxVNet
from vnet_tpu.models import build_network as jax_build_network
from vnet_tpu.models.attention import AttentionGatedVNet as JaxAttentionVNet
from vnet_tpu_torch import export
from vnet_tpu_torch.convert import flax_to_state_dict
from vnet_tpu_torch.export import main
from vnet_tpu_torch.models import VNet, build_network, eval_apply
from vnet_tpu_torch.ops import s2d
from vnet_tpu_torch.train import checkpoints

from torch_parity import random_variables

ATOL = 1e-5
TINY = dict(num_classes=2, num_channels=4, num_levels=1,
            num_convolutions=(1,), bottom_convolutions=1, dropout_rate=0.0)
SMALL = dict(num_classes=3, num_channels=4, num_levels=2,
             num_convolutions=(1, 2), bottom_convolutions=1, dropout_rate=0.0)
ATTENTION = dict(num_classes=2, num_channels=4, num_levels=2,
                 num_convolutions=(1, 2), bottom_convolutions=1,
                 dropout_rate=0.0, attention_channels=8, norm="batch")
# name -> (JAX module, port module, input shape, is_attention)
CASES = {
    # tests/test_export.py's model
    "vnet_8": (lambda: JaxVNet(**TINY), lambda: VNet(**TINY),
               (1, 8, 8, 8, 1), False),
    "packed_two_levels": (
        lambda: JaxVNet(conv_impl="packed", packed_target_lanes=16, **SMALL),
        lambda: VNet(conv_impl="packed", packed_target_lanes=16, **SMALL),
        (2, 16, 16, 16, 1), False),
    "attention": (lambda: JaxAttentionVNet(conv_impl="direct", **ATTENTION),
                  lambda: build_network("AttentionVNet", in_channels=2,
                                        device="cpu", **ATTENTION),
                  (2, 16, 16, 16, 2), True),
    "batch_stats": (lambda: JaxVNet(norm="batch_stats", **SMALL),
                    lambda: VNet(norm="batch_stats", **SMALL),
                    (2, 16, 16, 16, 1), False),
}


def _pair(name):
    make_jax, make_port, shape, is_attention = CASES[name]
    jnet = make_jax()
    variables = random_variables(jnet, np.random.default_rng(5),
                                 jnp.zeros(shape), train=False)
    net = make_port()
    net.load_state_dict(flax_to_state_dict(variables))
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    return jnet, variables, net, x, is_attention


def _jax_probs(jnet, variables, x, is_attention):
    blob = jax_export_forward(jnet, variables, x.shape,
                              is_attention=is_attention)
    return np.asarray(jax_load_exported(blob)(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_exported_forward_matches_jax(name):
    jnet, variables, net, x, is_attention = _pair(name)
    program = export.export_forward(net, x.shape, is_attention=is_attention,
                                    device="cpu")
    got = export.load_exported(program)(x).numpy()
    ref = _jax_probs(jnet, variables, x, is_attention)
    assert got.shape == x.shape[:-1] + (ref.shape[-1],)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_packed_export_before_any_eager_call():
    """The packed kernels' gather maps are cached at first use; made first
    under the exporter's fake tensors, they must still be real tensors
    (``ops/s2d.py::_pack_gather``), and the eager forward after the export
    equals the program's."""
    s2d._pack_gather.cache_clear()
    _, _, net, x, _ = _pair("packed_two_levels")
    got = export.load_exported(export.export_forward(net, x.shape,
                                                     device="cpu"))(x)
    ref = torch.softmax(eval_apply(net, torch.from_numpy(x)), dim=-1)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_saved_program_round_trips(tmp_path):
    _, _, net, x, _ = _pair("packed_two_levels")
    path = str(tmp_path / "forward.pt2")
    program = export.export_forward(net, x.shape, path=path, device="cpu")
    expected = export.load_exported(program)(x)
    with open(path, "rb") as f:
        blob = f.read()
    for saved in (path, blob):
        torch.testing.assert_close(export.load_exported(saved)(x), expected,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match=".pt2"):
        export.export_forward(net, x.shape, path=str(tmp_path / "forward"),
                              device="cpu")


def test_export_writes_no_buffer_and_keeps_the_mode():
    """Under ``batch_stats`` the forward reads the batch's statistics and
    leaves the running averages alone; the caller's mode is restored."""
    _, _, net, x, _ = _pair("batch_stats")
    net.train()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    program = export.export_forward(net, x.shape, device="cpu")
    assert net.training
    assert not program.graph_signature.buffers_to_mutate
    export.load_exported(program)(x)
    for key, value in net.state_dict().items():
        torch.testing.assert_close(value, before[key], rtol=0, atol=0)


def test_graph_text_names_a_convolution():
    _, _, net, x, _ = _pair("vnet_8")
    text = export.graph_text(net, x.shape, device="cpu")
    assert "aten.conv3d" in text
    assert "aten.softmax" in text or "aten._softmax" in text


def test_export_refuses_weights_elsewhere():
    _, _, net, x, _ = _pair("vnet_8")
    with pytest.raises(ValueError, match="weights lie on"):
        export.export_forward(net.to("meta"), x.shape,
                              device="cpu")


@pytest.fixture(scope="module")
def cli_export(tmp_path_factory):
    """``python -m vnet_tpu_torch.export`` on a tiny checkpoint: the
    package, the program and the graph code, beside JAX's forward of the
    same weights."""
    tmp = tmp_path_factory.mktemp("export_cli")
    jnet = jax_build_network("VNet", num_classes=3, num_channels=4,
                             num_levels=1, num_convolutions=(1,),
                             bottom_convolutions=1, dropout_rate=0.0)
    shape = (2, 8, 8, 8, 1)
    variables = random_variables(jnet, np.random.default_rng(8),
                                 jnp.zeros(shape), train=False)
    checkpoints.save(str(tmp / "ckpt"), flax_to_state_dict(variables), 0)
    config = {
        "TrainingSetting": {
            "SegmentationClasses": [0, 1, 2], "PatchShape": [8, 8, 8],
            "CheckpointDir": str(tmp / "ckpt"), "Precision": "float32",
            "Networks": {"Name": "VNet", "NumChannel": 4, "NumLevels": 1,
                         "NumConvolutions": [1], "BottomConvolutions": 1,
                         "Norm": "batch"}},
        "EvaluationSetting": {"CheckpointPath": str(tmp / "ckpt")}}
    (tmp / "config.json").write_text(json.dumps(config))
    main(["--config_json", str(tmp / "config.json"), "--out",
          str(tmp / "model.pt2"), "--batch", "2", "--text", "--device",
          "cpu"])
    x = np.random.default_rng(9).normal(size=shape).astype(np.float32)
    return tmp, x, _jax_probs(jnet, variables, x, False)


def test_cli_writes_the_package_the_program_and_the_text(cli_export):
    tmp, _, _ = cli_export
    assert (tmp / "model.pt2").stat().st_size > 0
    assert (tmp / "model.exported.pt2").stat().st_size > 0
    assert "aten.conv3d" in (tmp / "model.graph.txt").read_text()


def test_package_matches_jax(cli_export):
    tmp, x, ref = cli_export
    got = export.load_package(str(tmp / "model.pt2"))(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    program = export.load_exported(str(tmp / "model.exported.pt2"))
    np.testing.assert_allclose(program(x).numpy(), ref, atol=ATOL, rtol=0)
