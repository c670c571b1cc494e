"""Export of the eval forward: the counterpart of ``vnet_tpu/export.py``
and of ``scripts/export_model.py``.

JAX serialises the jitted eval forward (``eval_apply`` then a softmax over
the classes) as StableHLO with the weights baked in as constants; the
native PJRT client compiles it. Here the same function becomes:

* a ``torch.export`` ``ExportedProgram`` (:func:`export_forward`), saved
  with ``torch.export.save`` and re-imported by :func:`load_exported`;
* an AOTInductor package (:func:`export_package`, or
  :func:`compile_package` of an exported program), compiled ahead of time
  for one device with the weights inside: the artifact that the native
  runner ``vnet_infer_torch`` (``csrc/native/``) loads with libtorch's
  ``AOTIModelPackageLoader``;
* the exported graph's code (:func:`graph_text`), for inspection.

JAX's ``variables`` argument has no counterpart: the network module carries
its weights (restored by the ``Evaluator`` from ``ckpt_<step>.pt``) and they
are baked into the program. The forward takes ``(B, X, Y, Z, C)`` float32
at a fixed shape, casts to the network's dtype inside, as ``VNet.forward``
does, and returns float32 probabilities ``(B, X, Y, Z, K)``; for
``AttentionVNet`` those of its first output, the refined logits. The
network runs in eval mode: running averages, or the batch's own statistics
under ``Norm: batch_stats`` (every ``EvalNorm`` of the evaluator exports),
and no buffer is written. Nothing falls back: the export runs on ``cuda``
unless the caller asks for the CPU.

    python -m vnet_tpu_torch.export --config_json configs/config.json \\
        --out model_forward.pt2 --batch 8 [--text] [--device cuda]

writes the AOTInductor package to ``--out`` and the ``ExportedProgram``
beside it (``model_forward.exported.pt2``; both are ``.pt2`` files, the
only suffix ``torch.export.load`` reads), with ``--text`` the graph code
(``model_forward.graph.txt``).
"""

from __future__ import annotations

import argparse
import io
import os
from typing import Optional, Tuple

import torch
from torch import nn

from .device import resolve_device

# AOTInductor package metadata the native runner reads
INPUT_SHAPE_KEY = "vnet.input_shape"


class _Forward(nn.Module):
    """``softmax(eval forward)`` over the class axis."""

    def __init__(self, network: nn.Module, is_attention: bool):
        super().__init__()
        self.network = network
        self.is_attention = is_attention

    def forward(self, x):
        out = self.network(x)
        logits = out[0] if self.is_attention else out
        return torch.softmax(logits, dim=-1)


def _pt2(path: str) -> str:
    if not str(path).endswith(".pt2"):
        raise ValueError(f"{path!r}: an exported program or package is a "
                         f".pt2 file")
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    return str(path)


def export_forward(network: nn.Module, input_shape: Tuple[int, ...],
                   path: Optional[str] = None, is_attention: bool = False,
                   device="cuda") -> torch.export.ExportedProgram:
    """``torch.export`` of the eval forward with a softmax, for a float32
    input of ``input_shape`` (batch included, e.g. ``(B, X, Y, Z, C)``) on
    ``device``, where the network's weights must lie. Writes the program
    to ``path`` (a ``.pt2``) if given. The network's train/eval mode is
    restored afterwards."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    elsewhere = {str(p.device) for p in network.parameters()
                 if p.device != device}
    if elsewhere:
        raise ValueError(f"the network's weights lie on {sorted(elsewhere)}, "
                         f"not on {device}")
    was_training = network.training
    module = _Forward(network, is_attention).eval()
    try:
        example = torch.zeros(tuple(input_shape), dtype=torch.float32,
                              device=device)
        program = torch.export.export(module, (example,))
    finally:
        network.train(was_training)
    mutated = program.graph_signature.buffers_to_mutate
    if mutated:
        raise RuntimeError(f"the eval forward writes buffers: "
                           f"{sorted(mutated.values())}")
    if path:
        torch.export.save(program, _pt2(path))
    return program


def load_exported(program_or_path):
    """A callable ``f(x)`` -> probabilities of an exported forward: an
    ``ExportedProgram``, the path of a saved one or its bytes."""
    program = program_or_path
    if isinstance(program_or_path, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(program_or_path))
    elif isinstance(program_or_path, (str, os.PathLike)):
        program = torch.export.load(os.fspath(program_or_path))
    module = program.module()

    def call(x):
        with torch.no_grad():
            return module(torch.as_tensor(x))

    return call


def export_package(network: nn.Module, input_shape: Tuple[int, ...],
                   path: Optional[str] = None, is_attention: bool = False,
                   device="cuda") -> str:
    """The AOTInductor package of the eval forward, compiled for
    ``device`` with the weights inside (``export_stablehlo_bytecode``'s
    place): what ``vnet_infer_torch`` runs. Its metadata holds the input
    shape (``vnet.input_shape``, ``"B,X,Y,Z,C"``). Returns the package's
    path (``path``, a ``.pt2``, or one Inductor picks)."""
    return compile_package(export_forward(network, input_shape,
                                          is_attention=is_attention,
                                          device=device), path)


def compile_package(program: torch.export.ExportedProgram,
                    path: Optional[str] = None) -> str:
    """:func:`export_package` of a program :func:`export_forward` made, on
    its device."""
    from torch._inductor import aoti_compile_and_package

    from .native import compiler

    (example,) = program.example_inputs[0]
    metadata = {INPUT_SHAPE_KEY: ",".join(str(s) for s in example.shape)}
    # the package's C++ wrapper links OpenMP: built by the g++ that builds
    # the native runner, not by whatever $CXX names
    return aoti_compile_and_package(
        program, package_path=_pt2(path) if path else None,
        inductor_configs={"aot_inductor.metadata": metadata,
                          "cpp.cxx": (compiler(),)})


def load_package(path: str):
    """A callable ``f(x)`` -> probabilities of an AOTInductor package, on
    the device it was compiled for."""
    from torch._inductor import aoti_load_package

    return aoti_load_package(os.fspath(path))


def graph_text(network: nn.Module, input_shape: Tuple[int, ...],
               is_attention: bool = False, device="cuda") -> str:
    """The exported program as text (its signature and graph code), for
    inspection and debugging (``stablehlo_text``'s place)."""
    return str(export_forward(network, input_shape,
                              is_attention=is_attention, device=device))


def _stem(out: str) -> str:
    return out[:-len(".pt2")] if out.endswith(".pt2") else out


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m vnet_tpu_torch.export",
        description="Export a trained checkpoint's eval forward as an "
                    "AOTInductor package and a torch.export program")
    p.add_argument("--config_json", required=True)
    p.add_argument("--out", default="model_forward.pt2",
                   help="the AOTInductor package (.pt2); the exported "
                        "program goes beside it as <stem>.exported.pt2")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--text", action="store_true",
                   help="also write the graph code as <stem>.graph.txt")
    p.add_argument("--device", default="cuda",
                   help="the package's device (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)

    from .config import load_config
    from .infer.evaluator import Evaluator

    _pt2(args.out)
    config = load_config(args.config_json)
    ev = Evaluator(config, device=args.device)  # restores ckpt_<step>.pt
    t = config.train
    input_shape = (args.batch, *t.patch_shape, t.input_channels)
    stem = _stem(args.out)

    program = export_forward(ev.network, input_shape,
                             path=stem + ".exported.pt2",
                             is_attention=ev.is_attention, device=ev.device)
    print(f"wrote the exported program to {stem}.exported.pt2")
    package = compile_package(program, args.out)
    print(f"wrote the AOTInductor package for {ev.device} "
          f"({os.path.getsize(package)} bytes) to {package}")
    if args.text:
        with open(stem + ".graph.txt", "w") as f:
            f.write(str(program))
        print(f"wrote the graph code to {stem}.graph.txt")


if __name__ == "__main__":
    main()
