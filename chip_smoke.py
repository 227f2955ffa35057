"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``diffuncertainty_tpu_torch`` (never JAX, never ``diffuncertainty_tpu``):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` with plain ``nvcc`` (seconds printed);
3. each kernel against its plain PyTorch twin on the card, bf16, at the
   shapes the main path gives it; kernel, twin and library-call times
   (CUDA events, median of 20 after a warm-up) beside the bound;
4. the main path: unet16 with the trained toy-128 weights, 16 MC-dropout
   members x TTA folded into one 256-row bf16 forward on 16 images at
   128x128, with the kernels' launch counts read around that one call;
5. toy-128 quality of the bf16 path and of the fp32 "exact" path, held to
   bands around the JAX package's recorded numbers (PARITY.md section 3).

The fp32 path runs in true fp32: TF32 is off for cuDNN convolutions and for
matmuls. Any failure raises, so the exit code is non-zero and the last line
is not printed. The last line is the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parent
ASSET = REPO / "assets" / "bench_unet16_toy128.npz"

# bf16 kernel vs its twin: |kernel - twin| <= ATOL + RTOL*|twin| elementwise.
# One bf16 rounding step of the output is 2^-8 relative; the two differ only
# in the order of f32 sums, which can move the final rounding by one step.
ATOL, RTOL = 4e-3, 2.0 ** -7
# Toy-128 quality bands around PARITY.md section 3 (about 10x the JAX
# package's own fast-vs-exact deltas, for torch's different random draws).
PARITY = {
    "bf16": {"dice": 0.9496, "ged_bma": 0.0383, "aurc": 0.04505, "ece": 0.01436},
    "fp32": {"dice": 0.9493, "ged_bma": 0.0377, "aurc": 0.04552, "ece": 0.0138},
}
BANDS = {"dice": 0.005, "ged_bma": 0.005, "aurc": 0.01, "ece": 0.005}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BATCH, HW, MEMBERS = 16, 128, 16


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
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


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False")
    log(f"device 0: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi


def phase_build():
    from diffuncertainty_tpu_torch.ops import _build

    seconds = _build.build_all()
    log(f"build: {_build.sources()} with {_build.find_nvcc()} in {seconds:.2f}s")
    for name, out in _build.build_log.items():
        for line in out.strip().splitlines():
            log(f"  nvcc[{name}]: {line}")


def attention_case(b: int, t: int, c: int, heads: int, seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    out = ca.qkv_attention_cuda(qkv, heads)
    ref = ca.qkv_attention_reference(qkv, heads)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    max_err = err.max().item()
    bad = (err > ATOL + RTOL * ref.float().abs()).sum().item()
    if not torch.isfinite(out.float()).all() or bad:
        raise AssertionError(
            f"qkv_attention kernel disagrees with its twin at B={b} T={t} C={c}: "
            f"{bad} elements beyond {ATOL} + {RTOL}*|ref|, max |d| {max_err:.3e}")
    ms = median_ms(lambda: ca.qkv_attention_cuda(qkv, heads))
    plain_ms = median_ms(lambda: ca.qkv_attention_reference(qkv, heads), runs=5, warmup=1)
    ch = c // heads
    qh = qkv.view(b, t, heads, 3 * ch).permute(0, 2, 1, 3)
    q, k, v = (qh[..., i * ch:(i + 1) * ch].contiguous() for i in range(3))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=ch ** -0.5))
    flops = 4.0 * b * heads * t * t * ch
    nbytes = 2.0 * (b * t * 3 * c + b * t * c)
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_BYTES * 1e3
    case = {
        "B": b, "T": t, "C": c, "heads": heads, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bound_flops_ms, bound_bytes_ms),
        "bound_by": "operations" if bound_flops_ms >= bound_bytes_ms else "bytes",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }
    log(f"qkv_attention B={b} T={t} C={c} d={ch}: max|kernel-twin| {max_err:.3e}, "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}: {case['gflop']:.1f} GFLOP, "
        f"{case['mbytes']:.1f} MB)")
    del qkv, out, ref, q, k, v, qh
    torch.cuda.empty_cache()
    return case


def build_path(precision: str, separable: bool):
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.sampling.tta import TTAConfig

    cfg = load_config(data="lidc128", network="unet16", model="softmax", eu_method="dropout",
                      precision=precision)
    built = build_model(cfg, device="cuda")
    load_into(built.module, ASSET)
    tta = TTAConfig(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2),
                    separable_warp=separable)
    spec = SamplerSpec(n_pred=1, n_members=MEMBERS, member_mode="dropout", tta=True, tta_config=tta)
    torch.cuda.synchronize()
    return cfg, built, make_sampler(built, spec)


def phase_main_path(shapes_checked: set):
    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.models.unet import AttentionBlock
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset

    cfg, built, sampler = build_path("bf16", separable=True)
    ds = toy128_dataset(HW)
    images = torch.from_numpy(np.stack([ds.load(i)["image"] for i in range(BATCH)])).cuda()
    aug = cfg.data.augmentations
    images = normalize_batch(images, aug.mean, aug.std)
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append(tuple(args[0].shape)))
             for m in built.module.modules() if isinstance(m, AttentionBlock)]
    n_attn = len(hooks)

    ca.reset_launch_count()
    stack = sampler(images, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    launches = ca.launch_count()
    for h in hooks:
        h.remove()
    log(f"main path: groups {tuple(stack.groups.shape)}, qkv_attention launches {launches} "
        f"(AttentionBlocks {n_attn})")
    if launches != n_attn:
        raise AssertionError(f"kernel launched {launches} times, expected {n_attn}")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in seen}
    if shapes != shapes_checked:
        raise AssertionError(f"main path attention shapes {shapes} != checked {shapes_checked}")
    calls_per_shape = {s: sum(1 for b, hh, ww, c in seen if (b, hh * ww, c) == s) for s in shapes}

    groups = stack.groups.float()
    if not torch.isfinite(groups).all():
        raise AssertionError("non-finite probabilities in the stack")
    sum_err = (groups.sum(-1) - 1).abs().max().item()
    maps = uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)
    decomp_err = (maps["TU"] - maps["AU"] - maps["EU"]).abs().max().item()
    log(f"main path: max |sum_c p - 1| {sum_err:.2e}, max |TU-AU-EU| {decomp_err:.2e}, "
        f"mean EU {maps['EU'].mean().item():.4e}")
    if sum_err > 1e-5 or decomp_err > 1e-5 or (maps["EU"] < -1e-6).any():
        raise AssertionError("stack is not a simplex or the heatmaps do not decompose")

    # the fp32 path with the same generator draws the same TTA params and
    # dropout masks, and runs no kernel: the bf16 result must track it
    _, _, sampler32 = build_path("fp32", separable=True)
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    diff = (stack.mean - stack32.mean).abs()
    agree = (stack.mean.argmax(-1) == stack32.mean.argmax(-1)).float().mean().item()
    log(f"bf16 vs fp32 main path, same draws: mean |dp| {diff.mean().item():.3e}, "
        f"max |dp| {diff.max().item():.3e}, argmax agreement {agree:.5f}")
    if diff.mean().item() > 0.01 or agree < 0.99:
        raise AssertionError("bf16 main path does not track the fp32 path")
    del sampler32, stack32

    n_calls = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_calls):
        sampler(images, torch.Generator("cuda").manual_seed(1 + i))
    torch.cuda.synchronize()
    per_call = (time.perf_counter() - t0) / n_calls
    log(f"main path bf16: {per_call * 1e3:.1f} ms per call of {BATCH} images x {MEMBERS} "
        f"members -> {BATCH / per_call:.2f} img/s")
    return launches, calls_per_shape, BATCH / per_call


def phase_quality():
    from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval

    results = {}
    for precision, separable in (("bf16", True), ("fp32", False)):
        cfg, built, sampler = build_path(precision, separable)
        t0 = time.perf_counter()
        q = toy128_quality_eval(built, sampler, cfg.data, batch=BATCH, hw=HW, device="cuda")
        log(f"quality {precision} ({'separable' if separable else 'composed'} warp, "
            f"{time.perf_counter() - t0:.1f}s): {q}")
        for key, ref in PARITY[precision].items():
            if abs(q[key] - ref) > BANDS[key]:
                raise AssertionError(
                    f"{precision} {key} {q[key]:.5f} outside {ref} +- {BANDS[key]}")
        results[precision] = q
    return results


def main() -> int:
    sys.path.insert(0, str(REPO))
    smi = phase_device()
    import torch

    phase_build()
    cases = [attention_case(BATCH * MEMBERS, 1024, 128, 4, seed=1),
             attention_case(BATCH * MEMBERS, 256, 256, 4, seed=2)]
    checked = {(c["B"], c["T"], c["C"]) for c in cases}
    launches, calls_per_shape, img_s = phase_main_path(checked)
    quality = phase_quality()

    # one entry per kernel; times are for the work of one main-path forward
    per = {k: sum(calls_per_shape[(c["B"], c["T"], c["C"])] * c[k] for c in cases)
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bound_by = max(cases, key=lambda c: calls_per_shape[(c["B"], c["T"], c["C"])] * c["bound_ms"])
    kernels = [{
        "name": "qkv_attention",
        "route": "cuda",
        "source": "diffuncertainty_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "diffuncertainty_tpu/ops/pallas_attention.py:38",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": per["ms"],
        "plain_ms": per["plain_ms"],
        "bound_ms": per["bound_ms"],
        "bound_by": bound_by["bound_by"],
        "library_ms": per["library_ms"],
        "per": "one main-path forward: " + ", ".join(
            f"{calls_per_shape[(c['B'], c['T'], c['C'])]} calls at B={c['B']} T={c['T']} C={c['C']}"
            for c in cases),
        "shapes": cases,
    }]
    log(f"main path {img_s:.2f} img/s; quality {quality}")
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
