"""The shifted-window attention kernels (``ops/window_attention.py``,
``csrc/window_attention.cu``) held against their plain version and timed
on the card, at Swin UNETR's shapes.

    python -m vnet_tpu_torch.tools.wattn_bench [--out FILE.json] [--no-time]

:func:`check_call` runs the Function forward and backward in bf16 on a
seeded ``qkv``, bias table and cotangent and the plain version
(``window_attention_plain``) in float32 on the same bf16 values: O within
``OUT_RTOL`` of its largest entry (two bf16 roundings: P before its
product with V, O after it), the gradient of ``qkv`` within ``DQKV_RTOL``
(dS rounded to bf16 before its products, the gradient after them), the
bias table's gradient within ``DTABLE_RTOL`` of its largest entry
(float32 sums of float32 terms in another order, and ``D = rowsum(dO *
O)`` from the bf16 O where autograd's is ``rowsum(P * dP)``); the
Function's saved tensors hold no ``(BW, heads, N, N)`` tensor, and one call is one forward launch, one
backward launch and one bias-gradient call. The checked shapes
(``CHECKS``): stage 1 of a batch of 2 96^3 patches (343 windows of 343
tokens from the 49^3 padded grid, 3 heads, shifted and not) and stage 4's
216-token window (24 heads, MONAI's sliced index, no mask).

:func:`time_call` times one call at the benchmark cell's shapes (batch 8):
CUDA events around ``REPS`` forward calls and ``REPS`` forward and
backward calls, beside the bound (operations at 989 TFLOP/s or bytes at
3.35 TB/s, whichever is longer: forward ``4 N d`` operations a query row
and head, q, k, v read and O and the log-sum-exp written once; backward
``8 N d``, q, k, v, O, dO and the log-sum-exp read, dq, dk, dv written
once), the plain version in bf16 (the scores in device memory) and the
library route (:func:`library_attention`: SDPA's memory-efficient backend,
the bias and mask an additive mask broadcast over the batch, the bias
table's gradient through it), each forward and backward call with the
device memory it adds at its peak over the inputs. The card's name and
power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from ..device import card_line
from ..models.swin_unetr import region_ids, relative_position_index
from ..ops import window_attention as wa

OUT_RTOL = 1.5e-2
DQKV_RTOL = 3e-2
DTABLE_RTOL = 5e-3
REPS = 10
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# name: (batch, padded grid, window, shift, heads)
CHECKS = {
    "stage1_shifted_b2": (2, (49, 49, 49), (7, 7, 7), (3, 3, 3), 3),
    "stage1_b2": (2, (49, 49, 49), (7, 7, 7), (0, 0, 0), 3),
    "stage4_b2": (2, (6, 6, 6), (6, 6, 6), (0, 0, 0), 24),
}
# the cell's calls (batch 8), one a stage, shifted where the stage shifts
TIMED = {
    "stage1_b8": (8, (49, 49, 49), (7, 7, 7), (3, 3, 3), 3),
    "stage2_b8": (8, (28, 28, 28), (7, 7, 7), (3, 3, 3), 6),
    "stage3_b8": (8, (14, 14, 14), (7, 7, 7), (3, 3, 3), 12),
    "stage4_b8": (8, (6, 6, 6), (6, 6, 6), (0, 0, 0), 24),
}


def inputs(case, gen, device="cuda"):
    """``(qkv bf16, table, index, regions, cot bf16)`` of a case."""
    batch, grid, ws, ss, heads = case
    n = math.prod(ws)
    bw = batch * math.prod(g // w for g, w in zip(grid, ws))
    c = heads * wa.HEAD_WIDTH
    qkv = torch.randn(bw, n, 3 * c, generator=gen, device=device)
    table = torch.randn(13 ** 3, heads, generator=gen, device=device)
    cot = torch.randn(bw, n, c, generator=gen, device=device)
    index = relative_position_index((7, 7, 7))[:n, :n].to(device)
    regions = (region_ids(grid, ws, ss, device) if any(ss) else None)
    return qkv.bfloat16(), table, index, regions, cot.bfloat16()


def library_attention(qkv: torch.Tensor, heads: int, table: torch.Tensor,
                      index: torch.Tensor, regions=None,
                      backends=None) -> torch.Tensor:
    """The attention as one library call: ``F.scaled_dot_product_attention``
    (``backends``: ``torch.nn.attention.sdpa_kernel``'s list, the default
    dispatch for ``None``) with ``table[index]`` (and, shifted, the -100
    region mask) as an additive mask in ``qkv``'s dtype. Unshifted, ``q, k,
    v`` are ``(BW, heads, N, d)`` and the mask ``(1, heads, N, N)``; shifted,
    ``(B, nW * heads, N, d)`` against a ``(1, nW * heads, N, N)`` mask, so
    the mask is broadcast over the batch and never over the windows."""
    from torch.nn.attention import sdpa_kernel

    bw, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = qkv.view(bw, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    bias = wa.gathered_bias(table, index)
    if regions is None:
        rows, mask = (bw, heads), bias.unsqueeze(0)
    else:
        nw = regions.shape[0]
        rows = (bw // nw, nw * heads)
        mask = (bias.unsqueeze(0) + wa.region_mask(regions).unsqueeze(1)
                ).view(1, nw * heads, n, n)
    q, k, v = (t.reshape(*rows, n, d) for t in (q, k, v))
    mask = mask.to(qkv.dtype)
    if backends is None:
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    else:
        with sdpa_kernel(backends):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    return out.reshape(bw, heads, n, d).transpose(1, 2).reshape(bw, n, c)


def _rel(got, ref) -> float:
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def check_call(case, gen) -> dict:
    """The kernels against the plain version on one case (module
    docstring); raises on a failed check, returns the readings."""
    qkv, table, index, regions, cot = inputs(case, gen)
    heads = case[4]
    n = index.shape[0]
    counters = (wa.window_attention_fwd, wa.window_attention_bwd,
                wa.window_attention_dbias)
    before = [f.launches for f in counters]
    q1 = qkv.clone().requires_grad_(True)
    t1 = table.clone().requires_grad_(True)
    out = wa.window_attention(q1, heads, t1, index, regions)
    saved = [tuple(t.shape) for t in out.grad_fn.saved_tensors
             if t is not None]
    out.backward(cot)
    torch.cuda.synchronize()
    launches = [f.launches - b for f, b in zip(counters, before)]
    q2 = qkv.float().requires_grad_(True)
    t2 = table.clone().requires_grad_(True)
    want = wa.window_attention_plain(q2, heads, t2, index, regions)
    want.backward(cot.float())
    got = {"out": _rel(out, want), "dqkv": _rel(q1.grad, q2.grad),
           "dtable": _rel(t1.grad, t2.grad)}
    big = qkv.shape[0] * heads * n * n
    for what, limit in (("out", OUT_RTOL), ("dqkv", DQKV_RTOL),
                        ("dtable", DTABLE_RTOL)):
        if not got[what] <= limit:
            raise AssertionError(f"{case}: {what} {got[what]:.3g} > {limit}")
    if any(math.prod(s) >= big for s in saved):
        raise AssertionError(f"a saved tensor of {big} elements: {saved}")
    if launches != [1, 1, 1]:
        raise AssertionError(f"launches (fwd, bwd, dbias) {launches}")
    return dict(got, saved=saved, launches=launches)


def counts(bw: int, heads: int, n: int) -> dict:
    rows = bw * heads * n
    data = rows * wa.HEAD_WIDTH * 2
    return {"fwd_flops": 4.0 * rows * n * wa.HEAD_WIDTH,
            "fwd_bytes": 4.0 * data + 4 * rows,
            "bwd_flops": 8.0 * rows * n * wa.HEAD_WIDTH,
            "bwd_bytes": 8.0 * data + 4 * rows}


def _events_ms(fn, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _added_peak_gib(fn) -> float:
    """Device memory one call of ``fn`` adds at its peak, in GiB."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def library_call(case, gen) -> dict:
    """The library route (:func:`library_attention`, memory-efficient
    backend) on one case: its agreement with the float32 plain version (as
    :func:`check_call` reads the kernels'), event ms of one forward and
    backward call and the memory it adds; ``{"error": ...}`` where the
    backend refuses the call."""
    from torch.nn.attention import SDPBackend

    qkv, table, index, regions, cot = inputs(case, gen)
    heads = case[4]
    backends = [SDPBackend.EFFICIENT_ATTENTION]
    q = qkv.clone().requires_grad_(True)
    t = table.clone().requires_grad_(True)

    def step():
        library_attention(q, heads, t, index, regions,
                          backends).backward(cot)

    try:
        out = library_attention(q, heads, t, index, regions, backends)
        out.backward(cot)
    except RuntimeError as err:
        return {"library_error": str(err).splitlines()[0][:200]}
    q2 = qkv.float().requires_grad_(True)
    t2 = table.clone().requires_grad_(True)
    want = wa.window_attention_plain(q2, heads, t2, index, regions)
    want.backward(cot.float())
    got = {"library_out": _rel(out, want),
           "library_dqkv": _rel(q.grad, q2.grad),
           "library_dtable": _rel(t.grad, t2.grad)}
    del out, want, q2, t2
    q.grad = t.grad = None
    got["library_step_ms"] = _events_ms(step)
    got["library_added_gib"] = _added_peak_gib(step)
    return got


def time_call(case, gen) -> dict:
    """Event ms of one forward call and one forward and backward call, the
    bounds, the memory a call adds, and the plain version's (module
    docstring)."""
    qkv, table, index, regions, cot = inputs(case, gen)
    heads = case[4]
    q = qkv.clone().requires_grad_(True)
    t = table.clone().requires_grad_(True)

    def fwd():
        with torch.no_grad():
            wa.window_attention(qkv, heads, table, index, regions)

    def step():
        wa.window_attention(q, heads, t, index, regions).backward(cot)
        q.grad = t.grad = None

    def plain():
        wa.window_attention_plain(q, heads, t, index, regions).backward(cot)
        q.grad = t.grad = None

    k = counts(qkv.shape[0], heads, index.shape[0])
    fwd_bound = max(k["fwd_flops"] / PEAK_FLOPS, k["fwd_bytes"] / PEAK_BYTES)
    bwd_bound = max(k["bwd_flops"] / PEAK_FLOPS, k["bwd_bytes"] / PEAK_BYTES)
    out = {"fwd_ms": _events_ms(fwd), "step_ms": _events_ms(step),
           "fwd_bound_ms": 1e3 * fwd_bound,
           "step_bound_ms": 1e3 * (fwd_bound + bwd_bound)}
    out["fwd_roofline_pct"] = 100.0 * out["fwd_bound_ms"] / out["fwd_ms"]
    out["step_roofline_pct"] = 100.0 * out["step_bound_ms"] / out["step_ms"]
    out["added_gib"] = _added_peak_gib(step)
    q.grad = t.grad = None
    torch.cuda.empty_cache()
    out["plain_step_ms"] = _events_ms(plain, reps=2)
    out["plain_added_gib"] = _added_peak_gib(plain)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wattn_bench runs the kernels on a CUDA card")
    print(f"card: {card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, case in CHECKS.items():
        rows.append(dict(case=name, **check_call(case, gen)))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    if not args.no_time:
        for name, case in TIMED.items():
            rows.append(dict(case=name, **time_call(case, gen)))
            torch.cuda.empty_cache()
            rows[-1].update(library_call(case, gen))
            print(json.dumps(rows[-1]), flush=True)
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
