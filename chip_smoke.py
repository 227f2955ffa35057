"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``diffuncertainty_tpu_torch`` (never JAX, never ``diffuncertainty_tpu``):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` with plain ``nvcc``, one process per source,
   all started together (seconds printed);
3. each kernel against its plain PyTorch twin on the card, at the shapes the
   main paths give it: the fused-qkv attention kernel in bf16, the
   GroupNorm+activation kernel at every norm shape of one 256-row unet16
   forward in bf16 and fp32; kernel, twin and library-call times (CUDA
   events, median of 20 after a warm-up) beside the bound;
4. the softmax path: unet16 with the trained toy-128 weights, 16 MC-dropout
   members x TTA folded into one 256-row bf16 forward on 16 images at
   128x128, with the kernels' launch counts read around that one call;
5. the diffusion path: unet16 with the trained toy-128 diffusion weights,
   16 DDIM-10 trajectories on 16 images at 128x128 (ten 256-row bf16
   forwards per call), with the launch counts read around one call, and bf16
   held against fp32 from the same start noise;
6. toy-128 quality of the softmax bf16 and fp32 paths and of the diffusion
   bf16 path, held to bands around the JAX package's recorded numbers
   (PARITY.md section 3).

The fp32 paths run in true fp32: TF32 is off for cuDNN convolutions and for
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
ASSET_DIFFUSION = REPO / "assets" / "bench_unet16_toy128_diffusion.npz"

# kernel vs its twin: |kernel - twin| <= ATOL + RTOL*|twin| elementwise.
# bf16: one rounding step of the output is 2^-8 relative; the two differ only
# in the order of f32 sums, which can move the final rounding by one step.
# fp32 (GroupNorm only): the f32 statistics are summed in another order.
TOL = {"bfloat16": (4e-3, 2.0 ** -7), "float32": (1e-5, 1e-5)}
# Toy-128 quality bands around PARITY.md section 3 (about 10x the JAX
# package's own fast-vs-exact deltas, for torch's different random draws).
# The softmax numbers are on the 256-image test split (since round 4); the
# diffusion numbers were measured in rounds 2 and 3 (BENCH_r02/r03.json) on
# the 32-image split of that time, which is the first 32 images of today's
# split, and the diffusion family was not measured again: it is held on
# those 32 images and only reported on all 256.
PARITY = {
    "bf16": {"dice": 0.9496, "ged_bma": 0.0383, "aurc": 0.04505, "ece": 0.01436},
    "fp32": {"dice": 0.9493, "ged_bma": 0.0377, "aurc": 0.04552, "ece": 0.0138},
    "diffusion_bf16_32": {"dice": 0.9583, "ged_bma": 0.0185, "aurc": 0.03304, "ece": 0.01458},
}
BANDS = {"dice": 0.005, "ged_bma": 0.005, "aurc": 0.01, "ece": 0.005}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH, HW, MEMBERS = 16, 128, 16
TRAJECTORIES, DDIM_STEPS = 16, 10


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


def check_close(name: str, out, ref, dtype_name: str) -> float:
    import torch

    atol, rtol = TOL[dtype_name]
    err = (out.float() - ref.float()).abs()
    max_err = err.max().item()
    bad = (err > atol + rtol * ref.float().abs()).sum().item()
    if not torch.isfinite(out.float()).all() or bad:
        raise AssertionError(f"{name} disagrees with its twin: {bad} elements beyond "
                             f"{atol} + {rtol}*|ref|, max |d| {max_err:.3e}")
    return max_err


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
    log(f"build: {_build.sources()} with {_build.find_nvcc()} in {seconds:.2f}s "
        f"(one nvcc per source, in parallel)")
    for name, out in _build.build_log.items():
        for line in out.strip().splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc[{name}]: {line.strip()}")


def attention_case(b: int, t: int, c: int, heads: int, seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_attention as ca

    gen = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    out = ca.qkv_attention_cuda(qkv, heads)
    ref = ca.qkv_attention_reference(qkv, heads)
    torch.cuda.synchronize()
    max_err = check_close(f"qkv_attention kernel at B={b} T={t} C={c}", out, ref, "bfloat16")
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


def norm_sites() -> list[tuple]:
    """(shape without batch, dtype name, act) of every GroupNorm call in one
    bf16 unet16 forward at HW x HW, from a one-row forward on the host; the
    diffusion unet16 differs only in its input conv and time embedding."""
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.models.unet import GroupNorm32

    built = build_model(load_config(precision="bf16"), device="cpu")
    sites = []
    for m in built.module.modules():
        if isinstance(m, GroupNorm32):
            m.register_forward_pre_hook(lambda mod, args: sites.append(
                (tuple(args[0].shape[1:]), str(args[0].dtype).split(".")[-1], mod.act)))
    with torch.no_grad():
        built.module(torch.zeros(1, HW, HW, 3), torch.Generator().manual_seed(0))
    return sites


def group_norm_case(shape: tuple, dtype_name: str, act: str, seed: int) -> dict:
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.ops.norm import num_groups_for

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator("cuda").manual_seed(seed)
    c = shape[-1]
    x = (3.0 * torch.randn(shape, generator=gen, device="cuda") + 1.0).to(dtype)
    scale = torch.randn(c, generator=gen, device="cuda")
    bias = torch.randn(c, generator=gen, device="cuda")
    out = gn.group_norm_act(x, scale, bias, act)
    ref = gn.group_norm_act_reference(x, scale, bias, act)
    torch.cuda.synchronize()
    max_err = check_close(f"group_norm_act kernel at {shape} {dtype_name} {act}", out, ref,
                          dtype_name)
    ms = median_ms(lambda: gn.group_norm_act(x, scale, bias, act))
    plain_ms = median_ms(lambda: gn.group_norm_act_reference(x, scale, bias, act), runs=5,
                         warmup=1)
    # library: one F.group_norm (+ F.silu) on the channels-last NCHW view
    xv = x.movedim(-1, 1)
    sc, bi, groups = scale.to(dtype), bias.to(dtype), num_groups_for(c)

    def library():
        y = F.group_norm(xv, groups, sc, bi, 1e-5)
        return F.silu(y) if act == "silu" else y

    library_ms = median_ms(library)
    numel = x.numel()
    nbytes = 2.0 * numel * x.element_size() + 2 * c * 4
    # f32 operations per value: add, multiply, add (statistics), one fma
    # (normalize and affine), exp, add, divide (SiLU)
    flops = numel * (5.0 + (3.0 if act == "silu" else 0.0))
    bound_bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound_flops_ms = flops / PEAK_FP32_FLOPS * 1e3
    case = {
        "shape": list(shape), "dtype": dtype_name, "act": act, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bound_bytes_ms, bound_flops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_flops_ms else "operations",
        "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_flops_ms,
        "mbytes": nbytes / 1e6,
    }
    log(f"group_norm_act {shape} {dtype_name} {act}: max|kernel-twin| {max_err:.3e}, "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, F.group_norm {library_ms:.4f} ms, "
        f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}: {case['mbytes']:.1f} MB)")
    del x, xv, out, ref
    torch.cuda.empty_cache()
    return case


def build_path(precision: str, separable: bool, model: str = "softmax"):
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.sampling.tta import TTAConfig

    if model == "diffusion":
        cfg = load_config(data="lidc128", network="unet16", model="diffusion", eu_method="none",
                          precision=precision)
        built = build_model(cfg, device="cuda")
        load_into(built.module, ASSET_DIFFUSION)
        spec = SamplerSpec(n_pred=TRAJECTORIES, n_members=1, member_mode="single",
                           diffusion_sampler="ddim", diffusion_num_steps=DDIM_STEPS)
    else:
        cfg = load_config(data="lidc128", network="unet16", model="softmax",
                          eu_method="dropout", precision=precision)
        built = build_model(cfg, device="cuda")
        load_into(built.module, ASSET)
        tta = TTAConfig(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2),
                        separable_warp=separable)
        spec = SamplerSpec(n_pred=1, n_members=MEMBERS, member_mode="dropout", tta=True,
                           tta_config=tta)
    torch.cuda.synchronize()
    return cfg, built, make_sampler(built, spec)


def test_images(cfg):
    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset

    ds = toy128_dataset(HW)
    images = torch.from_numpy(np.stack([ds.load(i)["image"] for i in range(BATCH)])).cuda()
    aug = cfg.data.augmentations
    return normalize_batch(images, aug.mean, aug.std)


def counted_call(built, sampler, images, seed: int):
    """One sampler call with both kernels' launch counts set to 0 just before
    it and read just after, and every attention and GroupNorm input shape."""
    import torch

    from diffuncertainty_tpu_torch.models.unet import AttentionBlock, GroupNorm32
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    attn_seen, norm_seen = [], []
    hooks = []
    for m in built.module.modules():
        if isinstance(m, AttentionBlock):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: attn_seen.append(tuple(args[0].shape))))
        elif isinstance(m, GroupNorm32):
            hooks.append(m.register_forward_pre_hook(lambda mod, args: norm_seen.append(
                (tuple(args[0].shape), str(args[0].dtype).split(".")[-1], mod.act))))
    n_attn = sum(isinstance(m, AttentionBlock) for m in built.module.modules())
    n_norm = sum(isinstance(m, GroupNorm32) for m in built.module.modules())
    torch.cuda.synchronize()
    ca.reset_launch_count()
    gn.reset_launch_count()
    stack = sampler(images, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    launches = {"qkv_attention": ca.launch_count(), "group_norm_act": gn.launch_count()}
    for h in hooks:
        h.remove()
    return stack, launches, n_attn, n_norm, attn_seen, norm_seen


def check_stack(name: str, stack):
    import torch

    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps

    groups = stack.groups.float()
    if not torch.isfinite(groups).all():
        raise AssertionError(f"{name}: non-finite probabilities in the stack")
    sum_err = (groups.sum(-1) - 1).abs().max().item()
    maps = uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)
    decomp_err = (maps["TU"] - maps["AU"] - maps["EU"]).abs().max().item()
    log(f"{name}: groups {tuple(stack.groups.shape)}, max |sum_c p - 1| {sum_err:.2e}, "
        f"max |TU-AU-EU| {decomp_err:.2e}, mean EU {maps['EU'].mean().item():.4e}")
    if sum_err > 1e-5 or decomp_err > 1e-5 or (maps["EU"] < -1e-6).any():
        raise AssertionError(f"{name}: stack is not a simplex or the heatmaps do not decompose")


def check_tracks(name: str, stack, stack32):
    diff = (stack.mean - stack32.mean).abs()
    agree = (stack.mean.argmax(-1) == stack32.mean.argmax(-1)).float().mean().item()
    log(f"bf16 vs fp32 {name}, same draws: mean |dp| {diff.mean().item():.3e}, "
        f"max |dp| {diff.max().item():.3e}, argmax agreement {agree:.5f}")
    if diff.mean().item() > 0.01 or agree < 0.99:
        raise AssertionError(f"bf16 {name} does not track the fp32 path")


def time_calls(sampler, images, n_calls: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_calls):
        sampler(images, torch.Generator("cuda").manual_seed(1 + i))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n_calls


def check_launches(name: str, launches: dict, expected: dict):
    log(f"{name}: launches per call {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"{name}: kernel launches {launches} != {expected}")


def phase_main_path(attn_checked: set, norm_checked: set):
    import torch

    cfg, built, sampler = build_path("bf16", separable=True)
    images = test_images(cfg)
    stack, launches, n_attn, n_norm, attn_seen, norm_seen = counted_call(
        built, sampler, images, 0)
    check_launches("softmax path", launches, {"qkv_attention": n_attn, "group_norm_act": n_norm})
    if n_attn != 11 or n_norm != 56:
        raise AssertionError(f"unet16 has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if shapes != attn_checked:
        raise AssertionError(f"main path attention shapes {shapes} != checked {attn_checked}")
    if set(norm_seen) != norm_checked:
        raise AssertionError(f"main path norm sites {set(norm_seen) - norm_checked} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    check_stack("softmax path", stack)

    # the fp32 path with the same generator draws the same TTA params and
    # dropout masks: the bf16 result must track it
    _, _, sampler32 = build_path("fp32", separable=True)
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("softmax path", stack, stack32)
    del sampler32, stack32

    per_call = time_calls(sampler, images, 5)
    log(f"softmax path bf16: {per_call * 1e3:.1f} ms per call of {BATCH} images x {MEMBERS} "
        f"members -> {BATCH / per_call:.2f} img/s")
    return launches, attn_calls, norm_seen, BATCH / per_call


def phase_diffusion(norm_checked: set):
    import torch

    cfg, built, sampler = build_path("bf16", separable=True, model="diffusion")
    images = test_images(cfg)
    stack, launches, n_attn, n_norm, _, norm_seen = counted_call(built, sampler, images, 0)
    check_launches("diffusion path", launches, {"qkv_attention": DDIM_STEPS * n_attn,
                                                "group_norm_act": DDIM_STEPS * n_norm})
    if set(norm_seen) != norm_checked:
        raise AssertionError(f"diffusion norm sites {set(norm_seen) - norm_checked} unchecked")
    check_stack("diffusion path", stack)
    if stack.groups.shape != (TRAJECTORIES, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"diffusion stack shape {tuple(stack.groups.shape)}")

    # the fp32 model from the same generator seed starts from the same x_init
    _, _, sampler32 = build_path("fp32", separable=True, model="diffusion")
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("diffusion path", stack, stack32)
    del sampler32, stack32

    per_call = time_calls(sampler, images, 3)
    log(f"diffusion path bf16: {per_call * 1e3:.1f} ms per call of {BATCH} images x "
        f"{TRAJECTORIES} DDIM-{DDIM_STEPS} trajectories -> {BATCH / per_call:.3f} img/s")
    return launches, BATCH / per_call


def phase_quality():
    from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval

    results = {}
    # (key, precision, separable warp, model, images scored); a key in PARITY is held
    for key, precision, separable, model, n_images in (
            ("bf16", "bf16", True, "softmax", None), ("fp32", "fp32", False, "softmax", None),
            ("bf16_32", "bf16", True, "softmax", 32),
            ("diffusion_bf16_32", "bf16", True, "diffusion", 32),
            ("diffusion_bf16", "bf16", True, "diffusion", None)):
        cfg, built, sampler = build_path(precision, separable, model)
        t0 = time.perf_counter()
        q = toy128_quality_eval(built, sampler, cfg.data, batch=BATCH, hw=HW, device="cuda",
                                num_images=n_images)
        log(f"quality {key} ({model}, {'separable' if separable else 'composed'} warp, "
            f"{n_images or 'all'} test images, {time.perf_counter() - t0:.1f}s): {q}")
        for metric, ref in PARITY.get(key, {}).items():
            if abs(q[metric] - ref) > BANDS[metric]:
                raise AssertionError(
                    f"{key} {metric} {q[metric]:.5f} outside {ref} +- {BANDS[metric]}")
        results[key] = q
        if key == "diffusion_bf16_32":
            # the spread of the held numbers over other random draws (not held)
            runs = [q] + [toy128_quality_eval(built, sampler, cfg.data, batch=BATCH, hw=HW,
                                              device="cuda", num_images=n_images,
                                              seed_base=seed)
                          for seed in (1000, 2000, 3000, 4000)]
            log(f"quality {key} over seed bases 777, 1000-4000: " + ", ".join(
                f"{m} {min(r[m] for r in runs):.5f}..{max(r[m] for r in runs):.5f}"
                for m in q))
    return results


def main() -> int:
    sys.path.insert(0, str(REPO))
    smi = phase_device()
    import torch

    phase_build()
    # unet16 attends at its two deepest levels: HW/4 (C=128) and HW/8 (C=256)
    attn_cases = [attention_case(BATCH * MEMBERS, (HW // 4) ** 2, 128, 4, seed=1),
                  attention_case(BATCH * MEMBERS, (HW // 8) ** 2, 256, 4, seed=2)]
    attn_checked = {(c["B"], c["T"], c["C"]) for c in attn_cases}

    sites = norm_sites()
    rows = BATCH * MEMBERS
    distinct = sorted(set(sites), key=lambda s: (-s[0][0], s))
    log(f"GroupNorm sites of one forward: {len(sites)}, distinct (shape, dtype, act): "
        f"{len(distinct)}")
    # every site's shape in both dtypes: bf16 as the bf16 paths give it (and
    # fp32 at the head), fp32 as the fp32 paths give it
    norm_cases = {}
    for shape, act in sorted({(shape, act) for shape, _, act in distinct},
                             key=lambda sa: (-sa[0][0], sa)):
        for dt in ("bfloat16", "float32"):
            norm_cases[((rows,) + shape, dt, act)] = group_norm_case(
                (rows,) + shape, dt, act, seed=10 + len(norm_cases))
    norm_checked = {((rows,) + shape, dt, act) for shape, dt, act in distinct}

    launches, attn_calls, norm_seen, img_s = phase_main_path(attn_checked, norm_checked)
    diff_launches, diff_img_s = phase_diffusion(norm_checked)
    quality = phase_quality()

    # one entry per kernel; times are for the work of one main-path forward
    attn_per = {k: sum(attn_calls[(c["B"], c["T"], c["C"])] * c[k] for c in attn_cases)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    bound_by = max(attn_cases,
                   key=lambda c: attn_calls[(c["B"], c["T"], c["C"])] * c["bound_ms"])
    norm_per = {k: sum(norm_cases[site][k] for site in norm_seen)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms",
                          "bound_ops_ms")}
    kernels = [{
        "name": "qkv_attention",
        "route": "cuda",
        "source": "diffuncertainty_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "diffuncertainty_tpu/ops/pallas_attention.py:38",
        "launches": launches["qkv_attention"],
        "launches_by_path": {"softmax_call": launches["qkv_attention"],
                             "diffusion_call": diff_launches["qkv_attention"]},
        "max_abs_err": max(c["max_abs_err"] for c in attn_cases),
        "ms": attn_per["ms"],
        "plain_ms": attn_per["plain_ms"],
        "bound_ms": attn_per["bound_ms"],
        "bound_by": bound_by["bound_by"],
        "library_ms": attn_per["library_ms"],
        "per": f"one {BATCH * MEMBERS}-row unet16 forward (one softmax-path call; a diffusion call is "
               f"{DDIM_STEPS}): " + ", ".join(
            f"{attn_calls[(c['B'], c['T'], c['C'])]} calls at B={c['B']} T={c['T']} C={c['C']}"
            for c in attn_cases),
        "shapes": attn_cases,
    }, {
        "name": "group_norm_act",
        "route": "cuda",
        "source": "diffuncertainty_tpu_torch/csrc/group_norm_act.cu",
        "replaces": "diffuncertainty_tpu/ops/pallas_groupnorm.py:32",
        "launches": launches["group_norm_act"],
        "launches_by_path": {"softmax_call": launches["group_norm_act"],
                             "diffusion_call": diff_launches["group_norm_act"]},
        "max_abs_err": max(c["max_abs_err"] for c in norm_cases.values()),
        "ms": norm_per["ms"],
        "plain_ms": norm_per["plain_ms"],
        "bound_ms": norm_per["bound_ms"],
        "bound_by": ("bytes" if norm_per["bound_bytes_ms"] >= norm_per["bound_ops_ms"]
                     else "operations"),
        "library_ms": norm_per["library_ms"],
        "per": f"one {rows}-row unet16 forward: its {len(norm_seen)} GroupNorm sites at the "
               f"bf16 path's shapes and dtypes; a diffusion call is {DDIM_STEPS} forwards",
        "per_diffusion_call": {k: DDIM_STEPS * v for k, v in norm_per.items()},
        "shapes": list(norm_cases.values()),
    }]
    log(f"softmax path {img_s:.2f} img/s, diffusion path {diff_img_s:.3f} img/s; "
        f"quality {quality}")
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
