"""Per-site times of the GroupNorm+activation kernel on the card.

    python3 diffuncertainty_tpu_torch/tools/groupnorm_sites.py [--model softmax|ssn|prob_unet]
        [--rows 256 16] [--root DIR] [--alternatives] [--backward]

For every distinct GroupNorm site of one bf16 forward of ``--model``'s unet16
network at 128x128 (shape, dtype and activation as the bf16 paths give them;
default the softmax DiffUnet), at each row count:
the kernel's time as CUDA events around one wrapper call (median of 20 after
a warm-up; a launch shorter than the wrapper's host time counts the host
time too) and as device time (``torch.profiler``'s CUDA time of the kernel,
the mean of the last 20 of 40 launches), beside the byte bound (each input read
once and each output written once at 3.35 TB/s), and the wrapper's host time
per call. Then the per-forward sums
(each site times its calls in one forward). ``--root`` times the
``diffuncertainty_tpu_torch`` package of another checkout (say, the parent
commit unpacked beside this one), so two versions compare in one call; the
script imports only modules every version of the port has.
``--alternatives`` also times, per site, the launches that ``cluster_plan``
passes over: every slice held whole by blocks of one to an SM (up to 227 KB
of shared memory each), and K doubled until the grid fills the card twice
over (264 blocks).

``--backward`` times the two backward kernels instead, at every site of one
training forward of ``--model`` (the prob-U-Net's with its posterior encoder;
``--rows`` defaults to the trainers' batch of 16): the GroupNorm backward at
each GroupNorm site and the attention backward at each attention site, each
called through its wrapper on the forward's saved statistics. Per call: CUDA
events, device time and the device activities one call runs
(:func:`call_kernels`), host time, and the bound (:func:`norm_backward_bound`,
:func:`attention_backward_bound`); then the per-step sums.

Prints one JSON line last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12  # dense tensor cores
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
HW = 128
TRAIN_ROWS = 16  # the trainers' batch


MODELS = ("softmax", "ssn", "prob_unet")


def norm_sites(model: str = "softmax", hw: int = HW) -> list[tuple]:
    """(shape without batch, dtype name, act) of every GroupNorm call in one
    bf16 forward of ``model``'s unet16 network at hw x hw, in call order, from
    a one-row forward on the host. ``softmax``: the DiffUnet (the diffusion
    unet16 differs only in its input conv and time embedding); ``ssn``: the
    DiffUnet with its two SSN heads; ``prob_unet``: the base DiffUnet, then
    the prior encoder (the posterior serves training only)."""
    return model_sites(model, hw)[0]


def model_sites(model: str = "softmax", hw: int = HW, training: bool = False
                ) -> tuple[list[tuple], list[tuple]]:
    """The GroupNorm sites (as :func:`norm_sites`) and the attention sites
    (tokens, channels, heads), in call order, of one bf16 forward of
    ``model``'s unet16 network at hw x hw; with ``training`` the prob-U-Net
    also runs its posterior encoder, as its training forward does."""
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.models.unet import AttentionBlock, GroupNorm32

    eu_method = "dropout" if model == "softmax" else "none"
    cfg = load_config(model=model, eu_method=eu_method, precision="bf16")
    built = build_model(cfg, device="cpu")
    norms, attns = [], []
    for m in built.module.modules():
        if isinstance(m, GroupNorm32):
            m.register_forward_pre_hook(lambda mod, args: norms.append(
                (tuple(args[0].shape[1:]), str(args[0].dtype).split(".")[-1], mod.act)))
        elif isinstance(m, AttentionBlock):
            m.register_forward_pre_hook(lambda mod, args: attns.append(
                (args[0].shape[1] * args[0].shape[2], args[0].shape[3], mod.num_heads)))
    extra = {}
    if training and model == "prob_unet":
        extra["segm"] = torch.zeros(1, hw, hw, cfg.network.out_channels)
    with torch.no_grad():
        built.module(torch.zeros(1, hw, hw, 3), generator=torch.Generator().manual_seed(0),
                     **extra)
    return norms, attns


def device_ms(fn, n: int = 20, match: str = "group_norm_act", tries: int = 3) -> float | None:
    """Device time in ms of one launch of ``fn``: the mean CUDA time of the
    last ``n`` kernels whose name holds ``match`` in a ``torch.profiler``
    trace of 2n calls. The trace can miss launches (on the H100 it kept as
    few as 4 of the first 20, and once none of 40), so the first n calls
    only warm it up, a trace that kept fewer than n is taken again, up to
    ``tries`` times, and then the time is None: not measured."""
    import torch
    from torch.autograd import DeviceType

    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(2 * n):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA and match in e.name),
                         key=lambda e: e.time_range.start)
        if len(kernels) >= n:
            return sum(e.time_range.elapsed_us() for e in kernels[-n:]) / n / 1e3
    return None


def call_kernels(fn, n: int = 20, tries: int = 5, gap_s: float = 1e-3
                 ) -> tuple[float | None, int | None]:
    """Device time in ms of one call of ``fn`` and the device activities
    (kernels, fills, copies) it runs: a ``torch.profiler`` trace of 2n
    calls, the last n each made on an idle device (synchronised, then
    ``gap_s`` of pause), split into calls at those pauses. The trace can
    miss activities (see :func:`device_ms`), which only ever lowers a
    call's count: the count is the largest any call shows, and the time the
    mean of the calls that show it, summed over their activities. A trace
    in which fewer than half the n calls show it is taken again, up to
    ``tries`` times; then (None, None): not measured."""
    import time

    import torch
    from torch.autograd import DeviceType

    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(2 * n):
                if i >= n:
                    torch.cuda.synchronize()
                    time.sleep(gap_s)
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        calls, end = [], None
        for e in events:
            if end is None or e.time_range.start - end > gap_s * 1e6 / 2:
                calls.append([])
            calls[-1].append(e)
            end = e.time_range.end if end is None else max(end, e.time_range.end)
        tail = calls[-n:]
        count = max((len(c) for c in tail), default=0)
        whole = [c for c in tail if len(c) == count]
        if count and 2 * len(whole) >= n:
            us = sum(e.time_range.elapsed_us() for c in whole for e in c)
            return us / len(whole) / 1e3, count
    return None, None


def event_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event times around one call, after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def host_us(fn, n: int = 200) -> float:
    """Host time in µs of one call of ``fn`` (the launch, not the kernel):
    the host clock over ``n`` calls issued back to back, before the device
    is waited for."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def inputs(shape: tuple, dtype_name: str, seed: int):
    """x ~ 3 N(0, 1) + 1 in ``dtype_name``, scale and bias ~ N(0, 1) in fp32."""
    import torch

    gen = torch.Generator("cuda").manual_seed(seed)
    x = (3.0 * torch.randn(shape, generator=gen, device="cuda") + 1.0).to(
        getattr(torch, dtype_name))
    scale = torch.randn(shape[-1], generator=gen, device="cuda")
    bias = torch.randn(shape[-1], generator=gen, device="cuda")
    return x, scale, bias


def bound_ms(shape: tuple, dtype_name: str) -> float:
    """Each input value read once and each output written once at 3.35 TB/s,
    plus the fp32 affine."""
    import math

    numel = math.prod(shape)
    elem = 2 if dtype_name == "bfloat16" else 4
    return (2.0 * numel * elem + 2 * shape[-1] * 4) / PEAK_BYTES * 1e3


def norm_backward_bound(shape: tuple, elem: int, act: str, affine_numel: int
                        ) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the GroupNorm backward's
    bytes at 3.35 TB/s (x and dy read and dx written once at ``elem`` bytes a
    value, the (B, G) mean and var read, the f32 affine read and its two
    gradients written) and its f32 operations at 67 TFLOP/s (about 12 a
    value, 16 with SiLU's derivative)."""
    import math

    from diffuncertainty_tpu_torch.ops.norm import num_groups_for

    numel = math.prod(shape)
    nbytes = 3.0 * numel * elem + 2 * shape[0] * num_groups_for(shape[-1]) * 4 \
        + 4 * affine_numel * 4
    flops = numel * (12.0 + (4.0 if act == "silu" else 0.0))
    by_bytes, by_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32_FLOPS
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def attention_backward_bound(b: int, t: int, c: int, heads: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the attention backward's
    bf16 operations at 989 TFLOP/s (QK^T recomputed, dV, dP, dQ, dK: 10 B H
    T^2 D) and its bytes at 3.35 TB/s (qkv, o and dO read, the f32 row max
    and sum read, dqkv written)."""
    d = c // heads
    flops = 10.0 * b * heads * t * t * d
    nbytes = 2.0 * b * t * (3 * c + c + c + 3 * c) + 2 * 4.0 * b * heads * t
    by_ops, by_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(by_ops, by_bytes) * 1e3, "operations" if by_ops > by_bytes else "bytes"


def per_forward(per_site: list[dict], key: str) -> float | None:
    """Sum over the sites of calls x ``key``; None if a site lacks it."""
    values = [p["calls"] * p[key] for p in per_site if p[key] is not None]
    return sum(values) if len(values) == len(per_site) else None


def fmt(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def alternatives(gn, shape: tuple, dtype, rows: int) -> dict:
    """The launches ``cluster_plan`` passes over for ``rows`` elements of
    ``shape``: "one_per_sm", the smallest K whose blocks hold their whole slice
    in up to 227 KB each; "fill", the plan's K doubled until 264 blocks."""
    import math

    s, c = math.prod(shape[:-1]), shape[-1]
    plan = gn.cluster_plan(s, c, dtype, rows)
    wide = gn.block_threads(c, dtype)
    held = [gn.plan_for(s, c, dtype, k, wide, gn.SMEM_LIMIT) for k in gn.CLUSTER_SIZES]
    out = {"one_per_sm": next((p for p in held if p.mode == "resident"), held[-1])}
    k = plan.cluster
    while k < gn.CLUSTER_SIZES[-1] and rows * k < 2 * gn.SMS and 2 * k <= s:
        k *= 2
    if k != plan.cluster:
        budget = gn.THIRD_SMEM if plan.smem <= gn.THIRD_SMEM else gn.PAIR_SMEM
        out["fill"] = gn.plan_for(s, c, dtype, k, plan.threads, budget)
    return {name: p for name, p in out.items() if p != plan}


def backward_alternatives(gn, shape: tuple, dtype, rows: int) -> dict:
    """Backward launches beside the plan for ``rows`` elements of
    ``shape``: K = 4, 8 and 16 at each shared-memory budget (three blocks
    to an SM, two), holding what fits and streaming the rest."""
    import math

    s, c = math.prod(shape[:-1]), shape[-1]
    plan = gn.backward_plan(s, c, dtype, rows)
    out = {f"K{k}_{name}": gn.plan_for(s, c, dtype, k, plan.threads, budget, backward=True)
           for k in (4, 8, 16) for name, budget in (("third", gn.THIRD_SMEM),
                                                   ("pair", gn.PAIR_SMEM))}
    return {name: p for name, p in out.items() if p != plan}


def backward_sites(model: str, rows: int, alternatives: bool = False) -> dict:
    """Both backward kernels at every site of one training forward of
    ``model`` at ``rows`` rows: per distinct site its calls a step, CUDA
    events, device time and device activities a call
    (:func:`call_kernels`), host time a call and the bound; then the sums
    over a step. Prints a line per site and per kernel."""
    import math

    import torch

    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    norms, attns = model_sites(model, training=True)
    out = {}
    per_site = []
    for i, site in enumerate(sorted(set(norms), key=lambda s: (-s[0][0], s))):
        shape, dtype_name, act = site
        x, scale, bias = inputs((rows,) + shape, dtype_name, seed=10 + i)
        gen = torch.Generator("cuda").manual_seed(100 + i)
        gy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        _, mean, var = gn._forward(x, scale, bias, act, 1e-5, None, stats=True)
        call = lambda x=x, scale=scale, bias=bias, mean=mean, var=var, gy=gy, act=act: (  # noqa: E731
            gn._backward(x, scale, bias, mean, var, gy, act, 1e-5))
        bound, by = norm_backward_bound((rows,) + shape, x.element_size(), act, scale.numel())
        dev, kernels = call_kernels(call)
        per_site.append({"shape": list(shape), "dtype": dtype_name, "act": act,
                         "calls": norms.count(site), "ms": event_ms(call), "device_ms": dev,
                         "device_kernels": kernels, "host_us": host_us(call),
                         "bound_ms": bound, "bound_by": by})
        if alternatives:
            plan = gn.backward_plan(math.prod(shape[:-1]), shape[-1], x.dtype, rows)
            per_site[-1]["plan"] = plan._asdict()
            per_site[-1]["alternatives"] = {
                name: {"plan": p._asdict(), "device_ms": call_kernels(
                    lambda p=p: gn._backward(x, scale, bias, mean, var, gy, act, 1e-5, p))[0]}
                for name, p in backward_alternatives(gn, shape, x.dtype, rows).items()}
        del x, scale, bias, gy, mean, var
    out["group_norm_backward"] = per_site
    per_site = []
    for i, site in enumerate(sorted(set(attns))):
        t, c, heads = site
        gen = torch.Generator("cuda").manual_seed(200 + i)
        qkv = torch.randn((rows, t, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
        g_out = torch.randn((rows, t, c), generator=gen, device="cuda").to(torch.bfloat16)
        o, m, lsum = ca._forward(qkv, heads, stats=True)
        call = lambda qkv=qkv, o=o, m=m, lsum=lsum, g_out=g_out, heads=heads: (  # noqa: E731
            ca._backward(qkv, o, m, lsum, g_out, heads))
        bound, by = attention_backward_bound(rows, t, c, heads)
        dev, kernels = call_kernels(call)
        per_site.append({"tokens": t, "channels": c, "heads": heads, "calls": attns.count(site),
                         "ms": event_ms(call), "device_ms": dev, "device_kernels": kernels,
                         "host_us": host_us(call), "bound_ms": bound, "bound_by": by})
        del qkv, g_out, o, m, lsum
    out["attention_backward"] = per_site
    for kernel in ("group_norm_backward", "attention_backward"):
        sites = out[kernel]
        for p in sites:
            where = (f"{tuple(p['shape'])} {p['dtype']} {p['act']}" if "shape" in p
                     else f"T={p['tokens']} C={p['channels']} heads={p['heads']}")
            alt = "".join(f"; {name} {fmt(a['device_ms'])}"
                          for name, a in p.get("alternatives", {}).items())
            plan = "" if "plan" not in p else (f" (K={p['plan']['cluster']} {p['plan']['mode']}, "
                                               f"{p['plan']['smem']} B)")
            print(f"{kernel} rows {rows} {where} x{p['calls']}: event {fmt(p['ms'])}, device "
                  f"{fmt(p['device_ms'])} in {p['device_kernels']} device kernels{plan}, bound "
                  f"{fmt(p['bound_ms'])} ({p['bound_by']}), host {p['host_us']:.1f} us a call"
                  + alt, flush=True)
        sums = {k: per_forward(sites, k) for k in ("ms", "device_ms", "bound_ms")}
        sums["calls"] = sum(p["calls"] for p in sites)
        sums["host_us"] = sum(p["calls"] * p["host_us"] for p in sites)
        print(f"{kernel} rows {rows} per {model} training step ({sums['calls']} calls): event "
              f"{fmt(sums['ms'])}, device {fmt(sums['device_ms'])}, bound "
              f"{fmt(sums['bound_ms'])}, host {sums['host_us']:.1f} us", flush=True)
        out[f"{kernel}_per_step"] = sums
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", choices=MODELS, default="softmax",
                        help="whose forward's sites: the DiffUnet, the SSN or the prob-U-Net")
    parser.add_argument("--rows", type=int, nargs="+",
                        help="row counts (default 256 16; with --backward 16)")
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2],
                        help="checkout whose diffuncertainty_tpu_torch is timed")
    parser.add_argument("--alternatives", action="store_true",
                        help="also time the launches cluster_plan passes over (with "
                             "--backward: K 4, 8, 16 at each budget)")
    parser.add_argument("--backward", action="store_true",
                        help="time both backward kernels at the training sites instead")
    args = parser.parse_args()
    args.rows = args.rows or ([TRAIN_ROWS] if args.backward else [256, 16])
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from diffuncertainty_tpu_torch.ops import _build
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    if not torch.cuda.is_available():
        raise SystemExit("groupnorm_sites needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"package {Path(gn.__file__).resolve().parents[1]}; {smi}", flush=True)
    _build.build_all()
    for line in _build.build_log.get("group_norm_act", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip(), flush=True)
    small = torch.ones(16, device="cuda")
    add_us = host_us(lambda: torch.add(small, small))
    print(f"host time of one torch.add for reference: {add_us:.1f} us", flush=True)
    result = {"root": str(args.root.resolve()), "model": args.model, "device": smi,
              "add_host_us": add_us, "rows": {}}
    if args.backward:
        result["backward"] = True
        for rows in args.rows:
            result["rows"][rows] = backward_sites(args.model, rows, args.alternatives)
            torch.cuda.empty_cache()
        print(json.dumps(result), flush=True)
        return
    sites = norm_sites(args.model)
    distinct = sorted(set(sites), key=lambda s: (-s[0][0], s))
    for rows in args.rows:
        per_site = []
        for i, (shape, dtype_name, act) in enumerate(distinct):
            x, scale, bias = inputs((rows,) + shape, dtype_name, seed=10 + i)
            call = lambda x=x, scale=scale, bias=bias, act=act: gn.group_norm_act(  # noqa: E731
                x, scale, bias, act)
            per_site.append({"shape": list(shape), "dtype": dtype_name, "act": act,
                             "calls": sites.count((shape, dtype_name, act)),
                             "ms": event_ms(call), "device_ms": device_ms(call),
                             "host_us": host_us(call),
                             "bound_ms": bound_ms((rows,) + shape, dtype_name)})
            if args.alternatives:
                per_site[-1]["alternatives"] = {
                    name: {"plan": plan._asdict(), "device_ms": device_ms(
                        lambda plan=plan: gn.group_norm_act(x, scale, bias, act, plan=plan))}
                    for name, plan in alternatives(gn, shape, x.dtype, rows).items()}
            del x, scale, bias
        sums = {k: per_forward(per_site, k) for k in ("ms", "device_ms", "bound_ms")}
        for p in per_site:
            alt = "".join(f"; {name} {a['plan']['cluster']}x{a['plan']['threads']} "
                          f"{a['plan']['mode']} {fmt(a['device_ms'])}"
                          for name, a in p.get("alternatives", {}).items())
            print(f"rows {rows} {tuple(p['shape'])} {p['dtype']} {p['act']} x{p['calls']}: "
                  f"event {fmt(p['ms'])}, device {fmt(p['device_ms'])}, bound "
                  f"{fmt(p['bound_ms'])}, host {p['host_us']:.1f} us a call" + alt, flush=True)
        print(f"rows {rows} per forward: event {fmt(sums['ms'])}, device "
              f"{fmt(sums['device_ms'])}, bound {fmt(sums['bound_ms'])}", flush=True)
        result["rows"][rows] = {"sites": per_site, "per_forward": sums}
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
