"""The fused batch norm + activation kernels (``ops/bn_act.py``) at every
batch-norm site of the benchmark's three cells, held against their plain
versions and timed on the card.

    python -m vnet_tpu_torch.tools.bn_act_bench [--out FILE.json] [--list]
        [--no-time]

The sites come from the module trees: a forward pre-hook on every
batch-kind ``Norm`` of the network that the cell's config builds (packed,
as the trainer builds it), run once on the ``meta`` device at the cell's
patch; the batch is the cell's. Each distinct site ``(shape, groups,
activation)`` is then made on the card in bf16, channels-last, from a seed,
and :func:`check_site` holds each pass against its plain version: the
forward's sums (``bn_stats``) per packed channel within ``STATS_RTOL`` of
the sum of |terms|, the apply pass (output, saved ``(mean, inv)``, running
averages) bitwise given the same sums, the gradient sums within ``STATS_RTOL`` of the sum of their
|terms| given the same saved statistics, and ``dx`` within one ulp of the
dtype (plus ``DX_ATOL`` of max |dx|) given the same sums. The edge site
(the output norm's C = 3 unpacked, on the kernels' one-channel path; cell
1's own output norm is packed 24) comes after the cells'.

:func:`site_ms` times a site: CUDA events around ``REPS`` forward passes
(sums and apply) and backward passes (gradient sums and dx), beside the
byte bound of the fused site (x read once, y written once forward; x and dy
read once, dx written once backward, at 3.35 TB/s) and the eager chain
(``BatchNorm.eager`` then the activation, autograd for its backward) on the
same data. :func:`check_step` holds a traced training step's launches
(once per batch-norm site per pass) and kernel names; :func:`check_export`
holds ``export_forward`` on ``cuda`` (the tests and ``chip_smoke.py``
phase 28 call all three checks). ``--list`` prints the sites and exits;
it needs no card. The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import math
from collections import Counter
from pathlib import Path

import torch

from ..config import load_config
from ..device import card_line
from ..models import build_network
from ..models.layers import Activation, BatchNorm, Norm
from ..ops import bn_act as ba
from ..ops.fused import bn_stats

ROOT = Path(__file__).resolve().parents[2]
CELLS = {  # name: (config, patch, batch, train)
    "train_256x256x32_b32": (ROOT / "configs" / "config.json",
                             (256, 256, 32), 32, True),
    "attention_64_b16": (ROOT / "configs" /
                         "config_attention_multimodal.json",
                         (64, 64, 64), 16, True),
    "eval_256x256x32_b10": (ROOT / "configs" / "config_eval_gaussian.json",
                            (256, 256, 32), 10, False),
}
# the output norm's C = 3 unpacked (one channel a thread); packed 24 is
# cell 1's own
EDGE_SITES = (((32, 3, 64, 64, 32), 1, "none"),)
# float32 sums of up to 1.07 G terms in another order than the plain
# version's: allowed |diff| per channel relative to the sum of |terms|
STATS_RTOL = 1e-5
# dx: one ulp of the dtype of each element, plus this share of max |dx|
# (the sums' rounding, carried into every element)
DX_ATOL = 1e-5
REPS = 10
_FORMATS = {4: torch.channels_last, 5: torch.channels_last_3d}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM datasheet


def cell_network(cell: str, device="meta"):
    """``(network, patch, batch, input channels, train)`` of a cell: its
    config's network in bf16, built as the trainer builds it."""
    path, patch, batch, train = CELLS[cell]
    t = load_config(str(path)).train
    n = t.network
    net = build_network(
        "AttentionVNet" if n.attention else n.name,
        num_classes=t.num_classes, in_channels=t.input_channels,
        dropout_rate=n.dropout, num_channels=n.num_channel,
        num_levels=n.num_levels, num_convolutions=n.num_convolutions,
        bottom_convolutions=n.bottom_convolutions, norm=n.norm,
        packed_target_lanes=n.packed_target_lanes, dtype=torch.bfloat16,
        device=device, spatial_rank=t.dimension)
    return net, patch, batch, t.input_channels, train


def bn_sites(cell: str):
    """``[((shape, groups, act), layers)]``: the cell's distinct batch-norm
    sites in the order the forward first meets them, with their counts.
    One forward on the ``meta`` device (eval mode: the sites are the same
    in training)."""
    net, patch, batch, channels, _ = cell_network(cell)
    seen = []

    def hook(mod, args, kwargs):
        groups = args[1] if len(args) > 1 else kwargs.get("groups", 1)
        act = kwargs.get("act")
        seen.append(((batch,) + tuple(args[0].shape[1:]), int(groups),
                     "none" if act is None else act.kind))

    hooks = [m.register_forward_pre_hook(hook, with_kwargs=True)
             for m in net.modules()
             if isinstance(m, Norm) and m.kind in ("batch", "batch_stats")]
    net.eval()
    with torch.no_grad():
        net(torch.zeros((1,) + patch + (channels,), device="meta"))
    for h in hooks:
        h.remove()
    return list(Counter(seen).items())


def site_inputs(shape, groups, act, gen, dtype=torch.bfloat16):
    """Channels-last ``x`` (mean 0.5, per-channel scales), ``dy`` and float32
    parameters and running averages of a site, on the card."""
    c = shape[1] // groups
    fmt = _FORMATS.get(len(shape), torch.contiguous_format)
    dev = "cuda"
    scale = torch.rand((1, shape[1]) + (1,) * (len(shape) - 2),
                       generator=gen, device=dev) * 2 + 0.25
    x = (torch.randn(shape, generator=gen, device=dev) * scale + 0.5).to(
        dtype).contiguous(memory_format=fmt)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=fmt)
    p = dict(weight=torch.rand(c, generator=gen, device=dev) + 0.5,
             bias=torch.randn(c, generator=gen, device=dev) * 0.1,
             alpha=(torch.rand(c, generator=gen, device=dev) * 0.4 - 0.1
                    if act == "prelu" else None),
             running_mean=torch.randn(c, generator=gen, device=dev) * 0.1,
             running_var=torch.rand(c, generator=gen, device=dev) + 0.5)
    return x, dy, p


def _rel_err(got, want, terms) -> float:
    return float(((got - want).abs() / terms.clamp_min(1e-30)).max())


def check_site(shape, groups, act, gen, batch=True, dtype=torch.bfloat16):
    """Each pass of the site against its plain version on the same inputs
    (the module docstring); raises AssertionError, else returns the
    readings."""
    x, dy, p = site_inputs(shape, groups, act, gen, dtype)
    w, b, a = p["weight"], p["bias"], p["alpha"]
    out = {}
    axes = ba._grouped(x, groups)[1]
    if batch:
        got = ba.moment_sums(x)
        want = ba.moment_sums_plain(x)
        terms = torch.stack([ba.moment_sums_plain(x.abs())[0], want[1]])
        out["moments_rel_err"] = _rel_err(got, want, terms)
        assert out["moments_rel_err"] <= STATS_RTOL, out
        first, second = got.unbind(0)
        kind = ba.CLIPPED if groups == 1 else ba.MOMENTS
    else:
        first, second, kind = p["running_mean"], p["running_var"], ba.RUNNING
    runs = {}
    for name, fn in (("kernel", ba.bn_act_apply),
                     ("plain", ba.bn_act_apply_plain)):
        running = ((p["running_mean"].clone(), p["running_var"].clone())
                   if batch else None)
        y, saved = fn(x, first, second, kind, w, b, a, act, groups, running)
        runs[name] = (y, saved, running)
    (yk, sk, rk), (yp, sp, rp) = runs["kernel"], runs["plain"]
    out["apply_bitwise"] = bool(torch.equal(yk, yp) and torch.equal(sk, sp))
    out["running_bitwise"] = (not batch) or all(
        torch.equal(u, v) for u, v in zip(rk, rp))
    out["apply_channels_last"] = yk.is_contiguous(
        memory_format=_FORMATS.get(x.ndim, torch.contiguous_format))
    if not out["apply_bitwise"]:
        out["apply_mismatches"] = int((yk != yp).sum())
        out["saved_max_diff"] = float((sk - sp).abs().max())
    assert out["apply_bitwise"] and out["running_bitwise"], out
    assert out["apply_channels_last"], out
    del yk, yp, runs
    got = ba.bn_act_grad_sums(dy, x, sp, w, b, a, act, groups)
    want = ba.bn_act_grad_sums_plain(dy, x, sp, w, b, a, act, groups)
    z, xhat = ba._recompute(x, sp, w, b, groups)
    dz = ba._dz(dy, z, act, a, groups)
    terms = [dz.abs().sum(axes), (dz * xhat).abs().sum(axes)]
    if act == "prelu":
        terms.append((ba._grouped(dy, groups)[0].float()
                      * torch.clamp_max(z, 0)).abs().sum(axes))
    del z, xhat, dz
    out["grad_sums_rel_err"] = _rel_err(got, want, torch.stack(terms))
    assert out["grad_sums_rel_err"] <= STATS_RTOL, out
    sums = want[:2] if batch else None
    dxk = ba.bn_act_dx(dy, x, sp, w, b, a, sums, act, groups)
    dxp = ba.bn_act_dx_plain(dy, x, sp, w, b, a, sums, act, groups)
    diff = (dxk.float() - dxp.float()).abs()
    allowed = (dxp.float().abs() * torch.finfo(dtype).eps
               + DX_ATOL * float(dxp.float().abs().max()))
    out["dx_max_diff_over_allowed"] = float((diff / allowed).max())
    out["dx_mismatches"] = int((dxk != dxp).sum())
    assert out["dx_max_diff_over_allowed"] <= 1.0, out
    return out


def _events_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def site_ms(shape, groups, act, gen, batch=True):
    """Event ms of the site forward and backward on the kernels and on the
    eager chain, and the byte bounds."""
    x, dy, p = site_inputs(shape, groups, act, gen)
    c = shape[1] // groups
    bn = BatchNorm(c).to("cuda")
    am = Activation(act, c).to("cuda") if act != "none" else None
    with torch.no_grad():
        bn.weight.copy_(p["weight"])
        bn.bias.copy_(p["bias"])
        if am is not None and act == "prelu":
            am.prelu.weight.copy_(p["alpha"])
    bn.train(batch)
    xr = x.detach().requires_grad_()

    def fused():
        return bn(xr, not batch, groups, am)

    def eager():
        y = bn.eager(xr, not batch, groups)
        return y if am is None else am(y, groups)

    out = {}
    for name, fwd in (("kernel", fused), ("eager", eager)):
        out[f"{name}_fwd_ms"] = _events_ms(fwd)
        y = fwd()
        out[f"{name}_bwd_ms"] = _events_ms(
            lambda: torch.autograd.grad(y, xr, dy, retain_graph=True))
        del y
    nbytes = math.prod(shape) * x.element_size()
    out["bound_fwd_ms"] = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    out["bound_bwd_ms"] = 3 * nbytes / HBM_BYTES_PER_S * 1e3
    return out


# a site's kernels: bn_stats.cu's two (the forward's sums), bn_act.cu's four
KERNELS = ("bn_partial_kernel", "bn_reduce_kernel", "bn_act_partial_kernel",
           "bn_act_fold_kernel", "bn_act_apply_kernel", "bn_act_dx_kernel")
# what profiler.GROUPS reads as another group than elementwise: no fused
# kernel's name may hold one
OTHER_GROUPS = ("conv", "gemm", "xmma", "sm90", "implicit", "adam", "nccl",
                "memcpy")


def step_counts(make: str, remat: bool = False, patch=(32, 32, 32)):
    """One training step of a small ``make`` network (``flagship``: the
    packed config.json V-Net at batch 2; ``attention``: the attention-gated
    one at batch 1) under the profiler, after a warm-up step:
    ``(calls, launches, kernels)``: the batch-norm calls (``forward`` and
    ``recompute``), each wrapper's launches (``bn_stats``, apply, gradient
    sums, dx) and the :data:`KERNELS`' launches in the trace by name."""
    from ..models.layers import recomputing
    from .profile_step import attention_step, flagship_step
    if make == "flagship":
        state, step, images, labels = flagship_step("xla", 2, patch=patch,
                                                    remat=remat)
    else:
        state, step, images, labels = attention_step("xla", 1, patch=patch)
    calls = {"forward": 0, "recompute": 0}

    def hook(mod, args):
        calls["recompute" if recomputing() else "forward"] += 1

    hooks = [m.register_forward_pre_hook(hook)
             for m in state.network.modules()
             if isinstance(m, Norm) and m.kind in ("batch", "batch_stats")]
    step(state, images, labels, dropout_seed=1)
    calls.update(forward=0, recompute=0)
    wrappers = (bn_stats, ba.bn_act_apply, ba.bn_act_grad_sums, ba.bn_act_dx)
    before = [w.launches for w in wrappers]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(state, images, labels, dropout_seed=2)
        torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    names = Counter(e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(k in e.name for k in KERNELS))
    return (calls, [w.launches - b for w, b in zip(wrappers, before)],
            names)


def check_step(make: str, remat: bool = False) -> dict:
    """:func:`step_counts`, held: the forward's sums and apply once per
    batch-norm call (forward and recompute), gradient sums and dx once per
    forward site, the trace's kernels the counted ones, none named like
    another group's.
    Raises AssertionError, else returns the counts."""
    calls, launches, names = step_counts(make, remat)
    sites = calls["forward"]
    n_moments, n_apply, n_sums, n_dx = launches
    out = dict(calls=calls, launches=launches, trace=dict(names))
    assert sites > 0 and (calls["recompute"] > 0) == remat, out
    assert n_moments == n_apply == sites + calls["recompute"], out
    assert n_sums == n_dx == sites, out
    kinds = {k: sum(c for n, c in names.items() if k in n) for k in KERNELS}
    assert kinds == {"bn_partial_kernel": n_moments,
                     "bn_reduce_kernel": n_moments,
                     "bn_act_partial_kernel": n_sums,
                     "bn_act_fold_kernel": n_sums,
                     "bn_act_apply_kernel": n_apply,
                     "bn_act_dx_kernel": n_dx}, (kinds, out)
    for name in names:
        assert not any(w in name.lower() for w in OTHER_GROUPS), name
    return out


def check_export(seed: int = 0) -> float:
    """``export_forward`` of a small float32 V-Net on ``cuda``: the program
    launches no fused kernel (it is the plain network) and agrees with the
    module's eval forward, which does. Raises AssertionError, else returns
    the max |diff| of the probabilities."""
    from ..export import export_forward
    net = build_network("VNet", num_classes=3, num_channels=8, num_levels=2,
                        num_convolutions=(1, 2), bottom_convolutions=2,
                        dtype=torch.float32, device="cuda",
                        generator=torch.Generator().manual_seed(seed))
    shape = (1, 32, 32, 16, 1)
    program = export_forward(net, shape)
    x = torch.randn(shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    before = ba.bn_act_apply.launches
    with torch.no_grad():
        got = program.module()(x)
        assert ba.bn_act_apply.launches == before, "the program launched it"
        net.eval()
        want = torch.softmax(net(x), dim=-1)
    assert ba.bn_act_apply.launches > before
    err = float((got - want).abs().max())
    assert err <= 1e-4, err
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args(argv)
    rows = []
    for cell, (_, _, _, train) in CELLS.items():
        for (shape, groups, act), layers in bn_sites(cell):
            rows.append(dict(cell=cell, shape=list(shape), groups=groups,
                             act=act, layers=layers, batch=train))
    for shape, groups, act in EDGE_SITES:
        rows.append(dict(cell="edge", shape=list(shape), groups=groups,
                         act=act, layers=0, batch=True))
    if args.list:
        for r in rows:
            print(json.dumps(r))
        return rows
    if not torch.cuda.is_available():
        raise SystemExit("bn_act_bench times the kernels on a CUDA card")
    print(f"card: {card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for r in rows:
        shape, groups, act = tuple(r["shape"]), r["groups"], r["act"]
        r.update(check_site(shape, groups, act, gen, r["batch"]))
        torch.cuda.empty_cache()
        if not args.no_time:
            r.update(site_ms(shape, groups, act, gen, r["batch"]))
            torch.cuda.empty_cache()
        print(json.dumps(r), flush=True)
    for cell in CELLS:
        mine = [r for r in rows if r["cell"] == cell and "kernel_fwd_ms" in r]
        if mine:
            sums = {k: sum(r[k] * r["layers"] for r in mine) for k in
                    ("kernel_fwd_ms", "kernel_bwd_ms", "eager_fwd_ms",
                     "eager_bwd_ms", "bound_fwd_ms", "bound_bwd_ms")}
            print(json.dumps(dict(cell=cell, per_forward_and_backward=sums)),
                  flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
