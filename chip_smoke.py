"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--paths softmax,diffusion,ssn,prob_unet,ensemble,hrnet,multiclass]

With no argument every path runs; ``--paths`` picks a comma-separated group
of them (each needs its asset under ``assets/``: a missing one is an error).
The kernel build, the kernels' checks at the softmax path's shapes and at
every other head width, and the checks at every shape of the chosen paths
always run.

Drives ``diffuncertainty_tpu_torch`` (never JAX, never ``diffuncertainty_tpu``):

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` with plain ``nvcc``, one process per source,
   all started together (seconds printed);
   and what ``-Xptxas -v`` reports for each kernel instantiation
   (registers, spills);
3. each kernel against its plain PyTorch twin on the card, at the shapes the
   main paths give it: the fused-qkv attention kernel in bf16 at unet16's two
   attention shapes, and at every other head width the repo's networks use
   (one 256-row attention site of a network that has it, at 128x128) and at
   ragged token counts (8 rows, and 2 rows past 2048 tokens at d=16 and
   d=192); the GroupNorm+activation kernel at every
   norm shape of one unet16 forward in bf16 and fp32, at 256 rows and at the
   batch-1 path's 16 rows, with each launch's cluster plan (K, mode, shared
   memory, how many such clusters the card runs at once), at every other
   norm shape of one SSN and one prob-U-Net forward at their 16 rows (the
   prob-U-Net's widths 160 and 288 among them), and at unet256's
   1280- and 1536-channel norm shapes (2 rows, not timed); the attention
   kernel also at the 16-row sites of the SSN and prob-U-Net paths
   (d = 32, 64, 24, 48); kernel, twin and
   library-call times (CUDA events, median of 20 after a warm-up) beside the
   bound, and for GroupNorm also the kernel's device time (torch.profiler,
   the last 20 of 40 launches);
4. the softmax path: unet16 with the trained toy-128 weights, 16 MC-dropout
   members x TTA folded into one 256-row bf16 forward on 16 images at
   128x128, with the kernels' launch counts read around that one call;
5. the diffusion path: unet16 with the trained toy-128 diffusion weights,
   16 DDIM-10 trajectories on 16 images at 128x128 (ten 256-row bf16
   forwards per call), with the launch counts read around one call, and bf16
   held against fp32 from the same start noise;
6. the SSN path: unet16 with the trained toy-128 SSN weights, one 16-row
   bf16 forward on 16 images and 16 draws from its low-rank normal, with the
   launch counts read around one call, the count of elements whose
   covariance failed, and bf16 held against fp32 from the same draws;
7. the prob-U-Net path: the trained toy-128 prob-U-Net (base and prior
   encoder, one 16-row bf16 forward each, then 16 latent draws decoded by
   the fcomb), checked as the SSN path;
8. the ensemble path (``bench.py``'s "ensemble stack"): 16 unet16 members
   drawn on the card from the trained SWAG-diag moments (generator seed 42,
   scale 1.0), each one 16-row bf16 forward with MC-dropout live and its own
   TTA draw (``member_mode="params_stack"``), with the launch counts read
   around one call, the mean EU over pixels, bf16 held against fp32 with the
   same members and draws, the median time of 10 calls, and what binding a
   member's weights (``functional_call``) and casting them to bf16 cost;
9. the HRNet path (``bench.py``'s "hrnet x16"): hrnet-s with the trained
   toy-128 weights, 16 MC-dropout members (final dropout) x TTA folded into
   one 256-row bf16 forward on 16 images, BatchNorm on its running
   statistics; no attention or GroupNorm launch; the mean EU over pixels,
   bf16 held against fp32 with the same draws and the median time of 10
   calls;
10. the multiclass path (``bench.py``'s ``full_frame_multiclass``): unet16
   with the trained gta-toy label-switch weights (24 classes), 8 MC-dropout
   members one after another, each one 168-row bf16 forward of the 21
   windows (128, stride 64) of each of 8 frames of 256x512, tent-stitched;
   the kernels checked at its 168-row shapes first; the launch counts read
   around one call, frames/s from CUDA-event-timed calls after the first;
11. toy-128 quality of the softmax bf16 and fp32 paths, of the diffusion
   bf16 path and of the SSN, prob-U-Net, ensemble and HRNet bf16 paths, and
   the multiclass quality (macro Dice, GED, NCC of TU and AU against the
   analytic switch map), held to bands around the JAX package's recorded
   numbers (PARITY.md section 3 and its multiclass block, BENCH_r03.json,
   BENCH_r05.json).

Every counted call also counts the kernels' plain twins and fails if one ran.

The fp32 paths run in true fp32: TF32 is off for cuDNN convolutions and for
matmuls. Any failure raises, so the exit code is non-zero and the last line
is not printed. The last line is the device JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parent
ASSET = REPO / "assets" / "bench_unet16_toy128.npz"
ASSET_DIFFUSION = REPO / "assets" / "bench_unet16_toy128_diffusion.npz"
ASSET_SSN = REPO / "assets" / "bench_unet16_toy128_ssn.npz"
ASSET_PROB_UNET = REPO / "assets" / "bench_unet16_toy128_prob_unet.npz"
ASSET_SWAG = REPO / "assets" / "bench_unet16_toy128_swag.npz"
ASSET_HRNET = REPO / "assets" / "bench_hrnet_s_toy128.npz"
ASSET_MULTICLASS = REPO / "assets" / "bench_unet16_gtatoy_multiclass.npz"
PATH_ASSETS = {"softmax": ASSET, "diffusion": ASSET_DIFFUSION, "ssn": ASSET_SSN,
               "prob_unet": ASSET_PROB_UNET, "ensemble": ASSET_SWAG, "hrnet": ASSET_HRNET,
               "multiclass": ASSET_MULTICLASS}
PATHS = tuple(PATH_ASSETS)

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
# those 32 images and only reported on all 256. The SSN and prob-U-Net
# numbers (16 samples each) are on the 256-image split (since round 4), and
# so is the ensemble (16 SWAG-diag members x MC-dropout x TTA, BENCH_r05.json
# family_quality.ensemble_stack). HRNet was last measured in round 3
# (BENCH_r03.json ``hrnet.quality``) on the 32-image split: held there,
# reported on 256.
PARITY = {
    "bf16": {"dice": 0.9496, "ged_bma": 0.0383, "aurc": 0.04505, "ece": 0.01436},
    "fp32": {"dice": 0.9493, "ged_bma": 0.0377, "aurc": 0.04552, "ece": 0.0138},
    "diffusion_bf16_32": {"dice": 0.9583, "ged_bma": 0.0185, "aurc": 0.03304, "ece": 0.01458},
    "ssn_bf16": {"dice": 0.9462, "ged_bma": 0.0276, "aurc": 0.04918, "ece": 0.00958},
    "prob_unet_bf16": {"dice": 0.9486, "ged_bma": 0.0258, "aurc": 0.04531, "ece": 0.00341},
    "ensemble_bf16": {"dice": 0.9484, "ged_bma": 0.0397, "aurc": 0.04406, "ece": 0.00344},
    "hrnet_bf16_32": {"dice": 0.9498, "ged_bma": 0.0372, "aurc": 0.0483, "ece": 0.00778},
}
BANDS = {"dice": 0.005, "ged_bma": 0.005, "aurc": 0.01, "ece": 0.005}
# Multiclass quality (PARITY.md, multi-class block: fp32, the TPU's draws)
# and its bands: Dice and GED +-0.01, the NCCs +-0.02; the JAX package's own
# range over four dropout keys is narrower on every metric (PERF.md §6).
MULTICLASS_PARITY = {"dice_macro": 0.5084, "ged_multiclass": 0.313,
                     "ncc_tu_vs_analytic": 0.3406, "ncc_au_vs_analytic": 0.3389}
MULTICLASS_BANDS = {"dice_macro": 0.01, "ged_multiclass": 0.01,
                    "ncc_tu_vs_analytic": 0.02, "ncc_au_vs_analytic": 0.02}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH, HW, MEMBERS = 16, 128, 16
TRAJECTORIES, DDIM_STEPS = 16, 10
SAMPLES = 16  # SSN logit draws and prob-U-Net latent draws per image
# (HW / side, C) of the attention sites of the 16-row SSN (unet16) and
# prob-U-Net (widths x0.75) forwards, T = side**2, 4 heads: d = 32, 64, 24, 48
ATTENTION_SITES16 = ((4, 128), (8, 256), (4, 96), (8, 192))
# per 16-row call: (attention launches, GroupNorm launches)
GENERATIVE16_LAUNCHES = {"ssn": (11, 58), "prob_unet": (16, 81)}
# the ensemble: 16 stacked members drawn from the SWAG-diag moments (seed 42)
SWAG_SEED = 42
# (T, C, network) of one attention site at 128x128 (4 heads) for every head
# width beside unet16's 32 and 64; timed at the main path's 256 rows
ATTENTION_WIDTH_SITES = ((1024, 64, "unet4"), (1024, 96, "prob-U-Net"),
                         (256, 192, "prob-U-Net"), (64, 384, "unet64"),
                         (256, 512, "unet256"), (64, 768, "unet256"))
# ragged token counts checked (not timed) at every head width, 8 rows
RAGGED_TOKENS = (1, 80, 1000)
# ragged token counts past the Pallas kernel's 2048, checked at the narrowest
# and widest head width, 2 rows
LONG_TOKENS = (2049, 4100)
# unet256's norms wider than 1024 channels at 128x128 (shape without batch),
# checked (not timed) at 2 rows
WIDE_NORM_SITES = ((8, 8, 1280), (8, 8, 1536), (16, 16, 1280))
# attention calls per unet16 forward by token count: 5 at HW/4, 6 at HW/8
UNET16_ATTENTION = {(HW // 4) ** 2: (5, 128), (HW // 8) ** 2: (6, 256)}
# the multiclass path (bench.py:698-701): frames, frame size, window, stride,
# members, switched references per frame, seed
MC_FRAMES, MC_SIZE, MC_WINDOW, MC_STRIDE, MC_MEMBERS, MC_SEED = 8, (256, 512), 128, 64, 8, 1234


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


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


def _kernel_name(demangled: str) -> str:
    """``void <unnamed>::kernel<(int)32>(args)`` -> ``kernel<32>``."""
    name = re.sub(r"\((?:int|bool)\)", "", demangled).replace("(anonymous namespace)", "")
    return re.sub(r"\(.*", "", name).split("::")[-1]


def ptxas_report(out: str) -> dict:
    """{kernel instantiation: registers and spills} from ``nvcc -Xptxas -v``."""
    names, entry, report = [], None, {}
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            names.append(entry)
        elif entry and ("registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.split(":", 1)[-1].strip()
                                                if "ptxas" in line else line.strip())
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and names:
        plain = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(plain) == len(names):
            short = {n: _kernel_name(p) for n, p in zip(names, plain)}
            report = {short[k]: v for k, v in report.items()}
    return {k: "; ".join(v) for k, v in report.items()}


def phase_build() -> dict:
    from diffuncertainty_tpu_torch.ops import _build

    seconds = _build.build_all()
    log(f"build: {_build.sources()} with {_build.find_nvcc()} in {seconds:.2f}s "
        f"(one nvcc per source, in parallel)")
    reports = {}
    for name, out in _build.build_log.items():
        if "error" in out.lower():
            log(f"  nvcc[{name}]: {out.strip()}")
        reports[name] = ptxas_report(out)
        for entry, text in reports[name].items():
            log(f"  ptxas[{name}] {entry}: {text}")
    return reports


def attention_case(b: int, t: int, c: int, heads: int, seed: int, timed: bool = True) -> dict:
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import event_ms as median_ms

    gen = torch.Generator("cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
    out = ca.qkv_attention_cuda(qkv, heads)
    ref = ca.qkv_attention_reference(qkv, heads)
    torch.cuda.synchronize()
    ch = c // heads
    max_err = check_close(f"qkv_attention kernel at B={b} T={t} C={c} d={ch}", out, ref,
                          "bfloat16")
    case = {"B": b, "T": t, "C": c, "heads": heads, "d": ch, "max_abs_err": max_err}
    if not timed:
        log(f"qkv_attention B={b} T={t} C={c} d={ch}: max|kernel-twin| {max_err:.3e}")
        return case
    ms = median_ms(lambda: ca.qkv_attention_cuda(qkv, heads))
    plain_ms = median_ms(lambda: ca.qkv_attention_reference(qkv, heads), runs=5, warmup=1)
    qh = qkv.view(b, t, heads, 3 * ch).permute(0, 2, 1, 3)
    q, k, v = (qh[..., i * ch:(i + 1) * ch].contiguous() for i in range(3))
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=ch ** -0.5))
    flops = 4.0 * b * heads * t * t * ch
    nbytes = 2.0 * (b * t * 3 * c + b * t * c)
    bound_flops_ms = flops / PEAK_BF16_FLOPS * 1e3
    bound_bytes_ms = nbytes / PEAK_BYTES * 1e3
    case.update({
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bound_flops_ms, bound_bytes_ms),
        "bound_by": "operations" if bound_flops_ms >= bound_bytes_ms else "bytes",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    })
    log(f"qkv_attention B={b} T={t} C={c} d={ch}: max|kernel-twin| {max_err:.3e}, "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
        f"(kernel/sdpa {ms / library_ms:.2f}), bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}: {case['gflop']:.1f} GFLOP, {case['mbytes']:.1f} MB; "
        f"kernel/bound {ms / case['bound_ms']:.2f})")
    del qkv, out, ref, q, k, v, qh
    torch.cuda.empty_cache()
    return case


def attention_width_cases() -> list[dict]:
    """Every other head width, timed at one network site, then every head
    width at ragged token counts, then long ragged inputs past 2048 tokens."""
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca

    rows = BATCH * MEMBERS
    cases = []
    for i, (t, c, network) in enumerate(ATTENTION_WIDTH_SITES):
        cases.append(dict(attention_case(rows, t, c, 4, seed=100 + i), network=network))
    for ch in ca.HEAD_DIMS:
        for t in RAGGED_TOKENS:
            cases.append(attention_case(8, t, 4 * ch, 4, seed=200 + ch + t, timed=False))
    for ch in (ca.HEAD_DIMS[0], ca.HEAD_DIMS[-1]):
        cases.append(attention_case(8, 2048, 4 * ch, 4, seed=300 + ch, timed=False))
        for t in LONG_TOKENS:
            cases.append(attention_case(2, t, 4 * ch, 4, seed=400 + ch + t, timed=False))
    widths = {c["d"] for c in cases}
    if widths != set(ca.HEAD_DIMS):
        raise AssertionError(f"head widths checked {sorted(widths)} != {ca.HEAD_DIMS}")
    return cases


def group_norm_case(shape: tuple, dtype_name: str, act: str, seed: int,
                    timed: bool = True) -> dict:
    import torch
    import torch.nn.functional as F

    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn
    from diffuncertainty_tpu_torch.ops.norm import num_groups_for
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import device_ms
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import event_ms as median_ms

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
    s = x.numel() // (shape[0] * c)
    plan = gn.cluster_plan(s, c, dtype, shape[0])
    clusters = gn.max_active_clusters(s, c, dtype, act, plan, x.device)
    case = {"shape": list(shape), "dtype": dtype_name, "act": act, "max_abs_err": max_err,
            "cluster": plan.cluster, "mode": plan.mode, "smem": plan.smem,
            "threads": plan.threads, "cache_pix": plan.cache_pix,
            "slice_pix": plan.slice_pix, "active_clusters": clusters}
    plan_text = (f"K={plan.cluster} {plan.mode} ({plan.cache_pix}/{plan.slice_pix} px cached), "
                 f"{plan.threads} threads, {plan.smem} B shared, {clusters} clusters at once")
    if not timed:
        log(f"group_norm_act {shape} {dtype_name} {act}: max|kernel-twin| {max_err:.3e}; "
            f"{plan_text}")
        return case
    ms = median_ms(lambda: gn.group_norm_act(x, scale, bias, act))
    dev_ms = device_ms(lambda: gn.group_norm_act(x, scale, bias, act))
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
    case.update({
        "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(bound_bytes_ms, bound_flops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_flops_ms else "operations",
        "bound_bytes_ms": bound_bytes_ms, "bound_ops_ms": bound_flops_ms,
        "mbytes": nbytes / 1e6,
    })
    device = "not measured" if dev_ms is None else (
        f"{dev_ms:.4f} ms, {dev_ms / case['bound_ms']:.2f}x the bound")
    log(f"group_norm_act {shape} {dtype_name} {act}: max|kernel-twin| {max_err:.3e}; "
        f"{plan_text}; kernel {ms:.4f} ms (device {device}), twin {plain_ms:.4f} ms, "
        f"F.group_norm {library_ms:.4f} ms, bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']}: {case['mbytes']:.1f} MB)")
    del x, xv, out, ref
    torch.cuda.empty_cache()
    return case


@functools.lru_cache(maxsize=1)
def ensemble_members():
    """The ensemble's 16 members, drawn once on the card from the SWAG-diag
    moments and shared by every ensemble sampler (bf16 and fp32)."""
    import torch

    from diffuncertainty_tpu_torch.core.params import load_swag_npz
    from diffuncertainty_tpu_torch.tools.bench_assets import swag_draw_members

    moments = load_swag_npz(ASSET_SWAG)
    return swag_draw_members(moments.mean, moments.std,
                             torch.Generator("cuda").manual_seed(SWAG_SEED), MEMBERS)


def build_path(precision: str, separable: bool, model: str = "softmax"):
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
    from diffuncertainty_tpu_torch.sampling.tta import TTAConfig

    members = None  # the ensemble's stacked member weights
    if model in ("ssn", "prob_unet"):
        cfg = load_config(data="lidc128", network="unet16", model=model, eu_method="none",
                          precision=precision)
        built = build_model(cfg, device="cuda")
        load_into(built.module, ASSET_SSN if model == "ssn" else ASSET_PROB_UNET)
        spec = SamplerSpec(n_pred=SAMPLES, n_members=1, member_mode="single")
    elif model == "diffusion":
        cfg = load_config(data="lidc128", network="unet16", model="diffusion", eu_method="none",
                          precision=precision)
        built = build_model(cfg, device="cuda")
        load_into(built.module, ASSET_DIFFUSION)
        spec = SamplerSpec(n_pred=TRAJECTORIES, n_members=1, member_mode="single",
                           diffusion_sampler="ddim", diffusion_num_steps=DDIM_STEPS)
    else:  # softmax, the ensemble or HRNet: bench.py's build() with dropout live
        cfg = load_config(data="lidc128", network="hrnet-s" if model == "hrnet" else "unet16",
                          model="softmax", eu_method="dropout", precision=precision)
        built = build_model(cfg, device="cuda")
        if model == "ensemble":
            members = ensemble_members()
        else:
            load_into(built.module, ASSET_HRNET if model == "hrnet" else ASSET)
        tta = TTAConfig(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2),
                        separable_warp=separable)
        spec = SamplerSpec(n_pred=1, n_members=MEMBERS, tta=True, tta_config=tta,
                           member_mode="dropout" if members is None else "params_stack")
    torch.cuda.synchronize()
    return cfg, built, make_sampler(built, spec, members=members)


def test_images(cfg):
    import numpy as np
    import torch

    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.tools.quality import toy128_dataset

    ds = toy128_dataset(HW)
    images = torch.from_numpy(np.stack([ds.load(i)["image"] for i in range(BATCH)])).cuda()
    aug = cfg.data.augmentations
    return normalize_batch(images, aug.mean, aug.std)


@contextlib.contextmanager
def counting_twins():
    """Counts, per kernel, the calls of its plain twin while the block runs:
    the attention gate's fp32 route and both wrappers' CPU route."""
    from diffuncertainty_tpu_torch.ops import attention
    from diffuncertainty_tpu_torch.ops import cuda_attention as ca
    from diffuncertainty_tpu_torch.ops import cuda_groupnorm as gn

    calls = {"qkv_attention": 0, "group_norm_act": 0}
    sites = ((attention, "qkv_attention_reference", "qkv_attention"),
             (ca, "qkv_attention_reference", "qkv_attention"),
             (gn, "group_norm_act_reference", "group_norm_act"))
    saved = [getattr(mod, name) for mod, name, _ in sites]

    def counter(fn, kernel):
        def twin(*args, **kwargs):
            calls[kernel] += 1
            return fn(*args, **kwargs)
        return twin

    try:
        for (mod, name, kernel), fn in zip(sites, saved):
            setattr(mod, name, counter(fn, kernel))
        yield calls
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def counted_call(built, sampler, images, seed: int):
    """One sampler call with both kernels' launch counts set to 0 just before
    it and read just after, and every attention and GroupNorm input shape;
    fails if a kernel's plain twin ran in the call."""
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
    with counting_twins() as twins:
        ca.reset_launch_count()
        gn.reset_launch_count()
        stack = sampler(images, torch.Generator("cuda").manual_seed(seed))
        torch.cuda.synchronize()
        launches = {"qkv_attention": ca.launch_count(), "group_norm_act": gn.launch_count()}
    for h in hooks:
        h.remove()
    if any(twins.values()):
        raise AssertionError(f"plain twins ran in the counted call: {twins}")
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


def phase_generative16(model: str, attn_checked: set, norm_checked: set):
    """The SSN or prob-U-Net path: one counted 16-row call, the stack, the
    SSN's covariance failures, bf16 against fp32 from the same draws, and
    the time per call."""
    import torch

    cfg, built, sampler = build_path("bf16", separable=True, model=model)
    images = test_images(cfg)
    stack, launches, _, _, attn_seen, norm_seen = counted_call(built, sampler, images, 0)
    n_attn, n_norm = GENERATIVE16_LAUNCHES[model]
    check_launches(f"{model} path", launches, {"qkv_attention": n_attn, "group_norm_act": n_norm})
    if (len(attn_seen), len(norm_seen)) != (n_attn, n_norm):
        raise AssertionError(f"{model}: {len(attn_seen)} attention and {len(norm_seen)} "
                             f"GroupNorm calls seen, expected {n_attn} and {n_norm}")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if not shapes <= attn_checked:
        raise AssertionError(f"{model} attention shapes {shapes - attn_checked} unchecked")
    if not set(norm_seen) <= norm_checked:
        raise AssertionError(f"{model} norm sites {set(norm_seen) - norm_checked} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    check_stack(f"{model} path", stack)
    if stack.groups.shape != (SAMPLES, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"{model} stack shape {tuple(stack.groups.shape)}")
    if model == "ssn":
        from diffuncertainty_tpu_torch.models.ssn import build_distribution

        with torch.no_grad():
            out = built.module(images)
        failed = int(build_distribution(out.ssn_mean, out.ssn_cov_diag,
                                        out.ssn_cov_factor).cov_failed.sum())
        log(f"ssn path: cov_failed {failed} of {BATCH} elements")
        if failed:
            raise AssertionError(f"ssn: the covariance failed for {failed} elements")

    # the fp32 model from the same generator seed takes the same draws
    _, _, sampler32 = build_path("fp32", separable=True, model=model)
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks(f"{model} path", stack, stack32)
    del sampler32, stack32

    per_call = time_calls(sampler, images, 10)
    log(f"{model} path bf16: {per_call * 1e3:.2f} ms per call of {BATCH} images x {SAMPLES} "
        f"samples -> {BATCH / per_call:.2f} img/s")
    return launches, attn_calls, norm_seen, BATCH / per_call


def median_call_s(sampler, images, n_calls: int) -> float:
    """Median host time of ``n_calls`` synchronized sampler calls."""
    import torch

    times = []
    for i in range(n_calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler(images, torch.Generator("cuda").manual_seed(1 + i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def member_overheads(built, members: dict, n_calls: int = 5) -> dict:
    """Host time of what a stacked member adds to a forward: binding its
    weights with ``functional_call`` (on a module that only holds the
    network, so no forward runs) and casting all its float32 weights to
    bf16, per call of 16 members (medians of ``n_calls``)."""
    import torch
    from torch import nn

    class Bind(nn.Module):
        def __init__(self, net):
            super().__init__()
            self.net = net

        def forward(self):
            return None

    bind = Bind(built.module)
    states = [{f"net.{k}": v[m] for k, v in members.items()} for m in range(MEMBERS)]

    def bind_all():
        for st in states:
            torch.func.functional_call(bind, st, ())

    def cast_all():
        for m in range(MEMBERS):
            for v in members.values():
                v[m].to(torch.bfloat16)

    out = {}
    for name, fn in (("functional_call_ms", bind_all), ("weight_casts_ms", cast_all)):
        times = []
        for _ in range(n_calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = statistics.median(times) * 1e3
    return out


def phase_ensemble(attn_checked16: set, norm_checked16: set):
    """The ensemble path: one counted call (16 member forwards at 16 rows),
    the stack and its EU, bf16 against fp32 with the same members and draws,
    the median time of 10 calls, and the member overheads."""
    import torch

    t0 = time.perf_counter()
    cfg, built, sampler = build_path("bf16", separable=True, model="ensemble")
    members = ensemble_members()
    log(f"ensemble path: {MEMBERS} members drawn from the SWAG-diag moments "
        f"({sum(v[0].numel() for v in members.values())} weights each, "
        f"{sum(v.numel() * v.element_size() for v in members.values()) / 1e6:.1f} MB of "
        f"float32 on the card) in {time.perf_counter() - t0:.2f}s")
    images = test_images(cfg)
    stack, launches, n_attn, n_norm, attn_seen, norm_seen = counted_call(built, sampler,
                                                                         images, 0)
    check_launches("ensemble path", launches, {"qkv_attention": MEMBERS * n_attn,
                                               "group_norm_act": MEMBERS * n_norm})
    if (n_attn, n_norm) != (11, 56):
        raise AssertionError(f"unet16 has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if not shapes <= attn_checked16:
        raise AssertionError(f"ensemble attention shapes {shapes - attn_checked16} unchecked")
    if not set(norm_seen) <= norm_checked16:
        raise AssertionError(f"ensemble norm sites {set(norm_seen) - norm_checked16} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    check_stack("ensemble path", stack)
    if stack.groups.shape != (MEMBERS, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"ensemble stack shape {tuple(stack.groups.shape)}")
    mean_eu("ensemble path", stack)
    spread = (stack.groups.float() - stack.groups[:1].float()).abs().amax(dim=(1, 2, 3, 4, 5))
    log("ensemble path: max |p_m - p_0| per member group "
        + ", ".join(f"{v:.3f}" for v in spread.tolist()))
    if not (spread[1:] > 1e-3).all():
        raise AssertionError("ensemble members do not differ")

    # the fp32 path with the same members and generator seed takes the same draws
    _, _, sampler32 = build_path("fp32", separable=True, model="ensemble")
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("ensemble path", stack, stack32)
    del sampler32, stack32

    per_call = median_call_s(sampler, images, 10)
    overheads = member_overheads(built, members)
    log(f"ensemble path bf16: {per_call * 1e3:.2f} ms per call (median of 10) of {BATCH} "
        f"images x {MEMBERS} members -> {BATCH / per_call:.2f} img/s; per call, binding "
        f"{MEMBERS} members' weights (functional_call) {overheads['functional_call_ms']:.2f} ms, "
        f"casting them to bf16 {overheads['weight_casts_ms']:.2f} ms")
    return launches, attn_calls, norm_seen, BATCH / per_call, overheads


def mean_eu(name: str, stack) -> float:
    """The mean EU over pixels of a stack's group means; fails if it is 0."""
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps

    eu = uncertainty_heatmaps(stack.group_means.float(), sample_axis=0, class_axis=-1)["EU"]
    eu_per_image = eu.flatten(1).mean(1)
    log(f"{name}: mean EU over pixels {eu.mean().item():.4e} (per image "
        + ", ".join(f"{v:.2e}" for v in eu_per_image.tolist()) + ")")
    if not eu.mean().item() > 0.0:
        raise AssertionError(f"{name}: members do not differ: EU is 0")
    return eu.mean().item()


def phase_hrnet():
    """The HRNet path: one counted call (one 256-row hrnet-s forward, no
    attention or GroupNorm launch), the stack and its EU, bf16 against fp32
    with the same draws, the median time of 10 calls."""
    import torch

    from diffuncertainty_tpu_torch.models.hrnet import BatchNorm, Conv

    cfg, built, sampler = build_path("bf16", separable=True, model="hrnet")
    images = test_images(cfg)
    # what the forward must do, from its shapes: conv multiply-adds, and the
    # bytes of every conv's and BatchNorm's input and output
    work = {"macs": 0, "bytes": 0}

    def count(mod, args, out):
        if isinstance(mod, Conv):
            work["macs"] += out.numel() * mod.weight[0].numel()
        work["bytes"] += args[0].numel() * args[0].element_size() + out.numel() * out.element_size()

    hooks = [m.register_forward_hook(count) for m in built.module.modules()
             if isinstance(m, (Conv, BatchNorm))]
    stack, launches, n_attn, n_norm, _, _ = counted_call(built, sampler, images, 0)
    for h in hooks:
        h.remove()
    log(f"hrnet path: {2 * work['macs'] / 1e9:.1f} GFLOP in its convs "
        f"({2 * work['macs'] / PEAK_BF16_FLOPS * 1e3:.3f} ms at the bf16 peak), "
        f"{work['bytes'] / 1e9:.2f} GB of conv and BatchNorm inputs and outputs "
        f"({work['bytes'] / PEAK_BYTES * 1e3:.3f} ms at the HBM peak) per call")
    check_launches("hrnet path", launches, {"qkv_attention": 0, "group_norm_act": 0})
    if (n_attn, n_norm) != (0, 0):
        raise AssertionError(f"hrnet-s has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    check_stack("hrnet path", stack)
    if stack.groups.shape != (MEMBERS, 1, BATCH, HW, HW, 2):
        raise AssertionError(f"hrnet stack shape {tuple(stack.groups.shape)}")
    eu = mean_eu("hrnet path", stack)

    # the fp32 path with the same generator draws the same TTA params and
    # final-dropout masks
    _, _, sampler32 = build_path("fp32", separable=True, model="hrnet")
    stack32 = sampler32(images, torch.Generator("cuda").manual_seed(0))
    check_tracks("hrnet path", stack, stack32)
    del sampler32, stack32

    per_call = median_call_s(sampler, images, 10)
    log(f"hrnet path bf16: {per_call * 1e3:.2f} ms per call (median of 10) of {BATCH} images x "
        f"{MEMBERS} members -> {BATCH / per_call:.2f} img/s")
    return launches, BATCH / per_call, eu


def build_multiclass():
    """bench.py's multiclass model (gta_toy, unet16, MC-dropout) with the
    trained label-switch weights, and its member sliding-window function."""
    import torch

    from diffuncertainty_tpu_torch.core.config import load_config
    from diffuncertainty_tpu_torch.core.params import load_into
    from diffuncertainty_tpu_torch.models.factory import build_model
    from diffuncertainty_tpu_torch.tools.multiclass_quality import member_sliding_window_fn

    cfg = load_config(data="gta_toy", network="unet16", model="softmax", eu_method="dropout",
                      precision="bf16")
    built = build_model(cfg, device="cuda")
    load_into(built.module, ASSET_MULTICLASS)
    fn = member_sliding_window_fn(built.module, window=MC_WINDOW, stride=MC_STRIDE,
                                  members=MC_MEMBERS)
    torch.cuda.synchronize()
    return cfg, built, fn


def multiclass_rows() -> int:
    """Tile rows of one multiclass member forward: windows per frame x frames."""
    from diffuncertainty_tpu_torch.infer.sliding_window import _window_offsets

    return MC_FRAMES * (len(_window_offsets(MC_SIZE[0], MC_WINDOW, MC_STRIDE))
                        * len(_window_offsets(MC_SIZE[1], MC_WINDOW, MC_STRIDE)))


def phase_multiclass(attn_checked: set, norm_checked: set):
    """The multiclass path: one counted call (8 members, each one 168-row
    unet16 forward), the stitched stack, frames/s from CUDA-event times of 5
    calls after the first."""
    import torch

    from diffuncertainty_tpu_torch.data.augment import normalize_batch
    from diffuncertainty_tpu_torch.ops.entropy import uncertainty_heatmaps
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import event_ms
    from diffuncertainty_tpu_torch.tools.multiclass_quality import gta_toy_frames

    t0 = time.perf_counter()
    frames, _ = gta_toy_frames(MC_FRAMES, MC_SIZE, MC_WINDOW, MC_SEED)
    log(f"multiclass path: gta-toy {frames.shape} generated or found in "
        f"{time.perf_counter() - t0:.2f}s")
    cfg, built, fn = build_multiclass()
    aug = cfg.data.augmentations
    x = normalize_batch(torch.from_numpy(frames).cuda(), aug.mean, aug.std)
    stack, launches, n_attn, n_norm, attn_seen, norm_seen = counted_call(built, fn, x, MC_SEED)
    check_launches("multiclass path", launches, {"qkv_attention": MC_MEMBERS * n_attn,
                                                 "group_norm_act": MC_MEMBERS * n_norm})
    if (n_attn, n_norm) != (11, 56):
        raise AssertionError(f"unet16 has {n_attn} AttentionBlocks and {n_norm} GroupNorms")
    shapes = {(b, hh * ww, c) for b, hh, ww, c in attn_seen}
    if shapes != attn_checked:
        raise AssertionError(f"multiclass attention shapes {shapes} != checked {attn_checked}")
    if set(norm_seen) != norm_checked:
        raise AssertionError(f"multiclass norm sites {set(norm_seen) ^ norm_checked} unchecked")
    attn_calls = {s: sum(1 for b, hh, ww, c in attn_seen if (b, hh * ww, c) == s) for s in shapes}
    want = (MC_MEMBERS, MC_FRAMES) + tuple(MC_SIZE) + (built.num_classes,)
    if tuple(stack.shape) != want or not torch.isfinite(stack).all():
        raise AssertionError(f"multiclass stack {tuple(stack.shape)} (expected {want}) or "
                             f"non-finite values")
    sum_err = (stack.float().sum(-1) - 1).abs().max().item()
    maps = uncertainty_heatmaps(stack.float(), sample_axis=0, class_axis=-1)
    decomp_err = (maps["TU"] - maps["AU"] - maps["EU"]).abs().max().item()
    log(f"multiclass path: stack {tuple(stack.shape)}, max |sum_c p - 1| {sum_err:.2e}, "
        f"max |TU-AU-EU| {decomp_err:.2e}, mean TU {maps['TU'].mean().item():.4e}, "
        f"mean EU {maps['EU'].mean().item():.4e}")
    if sum_err > 1e-4 or decomp_err > 1e-4 or not maps["EU"].mean().item() > 0.0:
        raise AssertionError("multiclass stack is not a simplex, its heatmaps do not "
                             "decompose, or its members do not differ")
    del stack, maps
    gens = iter(range(100, 200))
    ms = event_ms(lambda: fn(x, torch.Generator("cuda").manual_seed(next(gens))), runs=5,
                  warmup=1)
    log(f"multiclass path bf16: {ms:.2f} ms per call (CUDA events, median of 5 after one) of "
        f"{MC_FRAMES} frames {MC_SIZE[0]}x{MC_SIZE[1]} x {MC_MEMBERS} members, "
        f"{multiclass_rows()} rows per member forward -> {MC_FRAMES / ms * 1e3:.3f} frames/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del x
    torch.cuda.empty_cache()
    return launches, attn_calls, norm_seen, MC_FRAMES / ms * 1e3


def phase_multiclass_quality() -> dict:
    from diffuncertainty_tpu_torch.tools.multiclass_quality import gta_toy_quality_eval

    cfg, built, _ = build_multiclass()
    t0 = time.perf_counter()
    q = gta_toy_quality_eval(built, cfg.data, frames=MC_FRAMES, frame_size=MC_SIZE,
                             window=MC_WINDOW, stride=MC_STRIDE, members=MC_MEMBERS,
                             seed=MC_SEED, timing_reps=3, device="cuda")
    log(f"quality multiclass_bf16 ({MC_FRAMES} frames, {MC_MEMBERS} members, "
        f"{time.perf_counter() - t0:.1f}s): {q}")
    for metric, ref in MULTICLASS_PARITY.items():
        if abs(q[metric] - ref) > MULTICLASS_BANDS[metric]:
            raise AssertionError(f"multiclass_bf16 {metric} {q[metric]:.5f} outside "
                                 f"{ref} +- {MULTICLASS_BANDS[metric]}")
    return q


def phase_quality(paths):
    from diffuncertainty_tpu_torch.tools.quality import toy128_quality_eval

    results = {}
    # (key, precision, separable warp, model, images scored); a key in PARITY is held
    for key, precision, separable, model, n_images in (
            ("bf16", "bf16", True, "softmax", None), ("fp32", "fp32", False, "softmax", None),
            ("bf16_32", "bf16", True, "softmax", 32),
            ("diffusion_bf16_32", "bf16", True, "diffusion", 32),
            ("diffusion_bf16", "bf16", True, "diffusion", None),
            ("ssn_bf16", "bf16", True, "ssn", None),
            ("prob_unet_bf16", "bf16", True, "prob_unet", None),
            ("ensemble_bf16", "bf16", True, "ensemble", None),
            ("hrnet_bf16_32", "bf16", True, "hrnet", 32),
            ("hrnet_bf16", "bf16", True, "hrnet", None)):
        if model not in paths:
            continue
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


def parse_paths(argv) -> tuple[str, ...]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--paths", default=",".join(PATHS),
                        help=f"comma-separated subset of {', '.join(PATHS)} (default: all)")
    names = [p for p in parser.parse_args(argv).paths.split(",") if p]
    unknown = sorted(set(names) - set(PATHS))
    if unknown or not names:
        parser.error(f"unknown or no paths {unknown}; choose from {', '.join(PATHS)}")
    missing = [str(PATH_ASSETS[p]) for p in names if not PATH_ASSETS[p].is_file()]
    if missing:
        raise FileNotFoundError(f"assets of the chosen paths are missing: {missing}")
    return tuple(p for p in PATHS if p in names)


def main(argv=None) -> int:
    paths = parse_paths(argv)
    sys.path.insert(0, str(REPO))
    smi = phase_device()
    import torch

    log(f"paths: {', '.join(paths)}")
    ptxas = phase_build()
    from diffuncertainty_tpu_torch.tools.groupnorm_sites import fmt, norm_sites, per_forward
    rows = BATCH * MEMBERS
    rows16 = ("ssn", "prob_unet", "ensemble")
    # unet16 attends at its two deepest levels: HW/4 (C=128) and HW/8 (C=256);
    # the main path's 256-row sites always, the 16-row and 168-row sites with
    # the paths that run them
    attn_cases = [attention_case(rows, t, c, 4, seed=1 + i)
                  for i, (t, (_, c)) in enumerate(UNET16_ATTENTION.items())]
    attn_checked = {(c["B"], c["T"], c["C"]) for c in attn_cases}
    attn_cases16 = [attention_case(BATCH, (HW // div) ** 2, c, 4, seed=600 + i)
                    for i, (div, c) in enumerate(ATTENTION_SITES16)
                    if any(p in paths for p in rows16)]
    attn_checked16 = {(c["B"], c["T"], c["C"]) for c in attn_cases16}
    mc_rows = multiclass_rows()
    attn_cases168 = [attention_case(mc_rows, t, c, 4, seed=700 + i)
                     for i, (t, (_, c)) in enumerate(UNET16_ATTENTION.items())
                     if "multiclass" in paths]
    attn_checked168 = {(c["B"], c["T"], c["C"]) for c in attn_cases168}
    width_cases = attention_width_cases()

    sites = {model: norm_sites(model, HW) for model in ("softmax", "ssn", "prob_unet")}

    def distinct(site_list):
        return sorted(set(site_list), key=lambda s: (-s[0][0], s))

    log("GroupNorm sites of one forward: " + ", ".join(
        f"{model} {len(sl)} ({len(distinct(sl))} distinct (shape, dtype, act))"
        for model, sl in sites.items()))
    # every site's shape in both dtypes (bf16 as the bf16 paths give it, and
    # fp32 at the heads; fp32 as the fp32 paths give it) at the main paths'
    # 256 rows and the batch-1 path's 16; the SSN's and prob-U-Net's at the
    # 16 rows their calls run; at 168 rows the multiclass path's own sites
    groups = [(rows, ("softmax",), ("bfloat16", "float32"))]
    if any(p in paths for p in rows16):
        groups.append((BATCH, ("softmax", "ssn", "prob_unet"), ("bfloat16", "float32")))
    norm_cases = {}
    for n_rows, models, dtypes in groups:
        shape_acts = {(shape, act) for m in models for shape, _, act in sites[m]}
        for shape, act in sorted(shape_acts, key=lambda sa: (-sa[0][0], sa)):
            for dt in dtypes:
                key = ((n_rows,) + shape, dt, act)
                norm_cases[key] = group_norm_case(key[0], dt, act, seed=10 + len(norm_cases))
    if "multiclass" in paths:
        for shape, dt, act in distinct(sites["softmax"]):
            key = ((mc_rows,) + shape, dt, act)
            norm_cases[key] = group_norm_case(key[0], dt, act, seed=10 + len(norm_cases))
    wide_cases = [group_norm_case((2,) + shape, dt, "silu", seed=500 + i, timed=False)
                  for i, shape in enumerate(WIDE_NORM_SITES) for dt in ("bfloat16", "float32")]
    norm_checked = {((rows,) + shape, dt, act) for shape, dt, act in distinct(sites["softmax"])}
    norm_checked16 = {((BATCH,) + shape, dt, act) for m in ("ssn", "prob_unet")
                      for shape, dt, act in sites[m]}
    norm_checked168 = {((mc_rows,) + shape, dt, act) for shape, dt, act in sites["softmax"]}

    # the main-path launch counts: unet16's 11 attention and 56 GroupNorm
    # sites per forward (the softmax phase checks them)
    attn_calls = {(rows, t, c): n for t, (n, c) in UNET16_ATTENTION.items()}
    norm_seen = [((rows,) + shape, dt, act) for shape, dt, act in sites["softmax"]]
    launches_by_path, img_s = {}, {}
    if "softmax" in paths:
        launches_by_path["softmax"], seen_calls, norm_seen, img_s["softmax"] = phase_main_path(
            attn_checked, norm_checked)
        if seen_calls != attn_calls:
            raise AssertionError(f"softmax attention calls {seen_calls} != {attn_calls}")
    if "diffusion" in paths:
        launches_by_path["diffusion"], img_s["diffusion"] = phase_diffusion(norm_checked)
    generative = {model: phase_generative16(model, attn_checked16, norm_checked16)
                  for model in ("ssn", "prob_unet") if model in paths}
    for model, g in generative.items():
        launches_by_path[model], img_s[model] = g[0], g[3]
    if "ensemble" in paths:
        # the ensemble's members run unet16 forwards at 16 rows, the sites checked above
        norm_checked_ens = {((BATCH,) + shape, dt, act) for shape, dt, act in sites["softmax"]}
        (launches_by_path["ensemble"], ens_attn_calls, ens_norm_seen, img_s["ensemble"],
         ens_overheads) = phase_ensemble(attn_checked16, norm_checked_ens)
    if "hrnet" in paths:
        launches_by_path["hrnet"], img_s["hrnet"], hrnet_eu = phase_hrnet()
    if "multiclass" in paths:
        (launches_by_path["multiclass"], mc_attn_calls, mc_norm_seen,
         frames_s) = phase_multiclass(attn_checked168, norm_checked168)
    quality = phase_quality(paths)
    if "multiclass" in paths:
        quality["multiclass_bf16"] = phase_multiclass_quality()

    # one entry per kernel; times are for the work of one main-path forward
    def attn_sum(cases, calls):
        return {k: sum(calls.get((c["B"], c["T"], c["C"]), 0) * c[k] for c in cases)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

    def calls_text(calls):
        return ", ".join(f"{n} calls at B={b} T={t} C={c}" for (b, t, c), n in sorted(calls.items()))

    attn_per = attn_sum(attn_cases, attn_calls)
    bound_by = max(attn_cases,
                   key=lambda c: attn_calls[(c["B"], c["T"], c["C"])] * c["bound_ms"])
    attn_extra = {f"{model}_forward16": dict(attn_sum(attn_cases16, g[1]), per=(
        f"one {BATCH}-row {model} call: " + calls_text(g[1])))
        for model, g in generative.items()}
    # GroupNorm per forward at 256 rows (the main paths) and at 16 (batch-1,
    # and the SSN's and prob-U-Net's calls)
    norm_keys = ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_bytes_ms",
                 "bound_ops_ms")

    def norm_sum(seen, n_rows):
        return {k: per_forward([dict(norm_cases[((n_rows,) + shape[1:], dt, act)], calls=1)
                                for shape, dt, act in seen], k) for k in norm_keys}

    norm_per = norm_sum(norm_seen, rows)
    norm_extra = {f"{model}_forward16": dict(norm_sum(g[2], BATCH), per=(
        f"one {BATCH}-row {model} call: its {len(g[2])} GroupNorm sites"))
        for model, g in generative.items()}
    if any(p in paths for p in rows16):
        norm_extra["rows16"] = dict(norm_sum(norm_seen, BATCH),
                                    per=f"one {BATCH}-row unet16 forward (the batch-1 path)")
    if "ensemble" in paths:
        ens_per = f"one ensemble call: {MEMBERS} member forwards of {BATCH} rows"
        attn_extra["ensemble_call"] = dict(attn_sum(attn_cases16, ens_attn_calls), per=ens_per)
        norm_extra["ensemble_call"] = dict(norm_sum(ens_norm_seen, BATCH), per=ens_per)
    if "multiclass" in paths:
        # one member forward of the multiclass call (a call is MC_MEMBERS of them)
        mc_attn_forward = {k: n // MC_MEMBERS for k, n in mc_attn_calls.items()}
        mc_per = (f"one {mc_rows}-row member forward of the multiclass call (a call is "
                  f"{MC_MEMBERS}): ")
        attn_extra["multiclass_forward168"] = dict(attn_sum(attn_cases168, mc_attn_forward),
                                                   per=mc_per + calls_text(mc_attn_forward))
        norm_extra["multiclass_forward168"] = dict(
            norm_sum(mc_norm_seen[:len(mc_norm_seen) // MC_MEMBERS], mc_rows),
            per=mc_per + f"its {len(mc_norm_seen) // MC_MEMBERS} GroupNorm sites")
    log(f"GroupNorm per {rows}-row forward: device {fmt(norm_per['device_ms'])} (events "
        f"{fmt(norm_per['ms'])}), bound {fmt(norm_per['bound_ms'])}, F.group_norm "
        f"{fmt(norm_per['library_ms'])}")
    for key in norm_extra:
        n = norm_extra[key]
        a = attn_extra.get(key)
        attn_text = "" if a is None else (
            f"attention kernel {a['ms']:.4f} ms, sdpa {a['library_ms']:.4f} ms, bound "
            f"{a['bound_ms']:.4f} ms; ")
        log(f"{key}: {attn_text}GroupNorm device {fmt(n['device_ms'])} (events "
            f"{fmt(n['ms'])}), F.group_norm {fmt(n['library_ms'])}, bound {fmt(n['bound_ms'])}")
    # the main path: softmax, else the chosen path that launches the kernels most
    main_path = "softmax" if "softmax" in paths else max(
        launches_by_path, key=lambda p: sum(launches_by_path[p].values()))

    def launches(kernel):
        return {"launches": launches_by_path.get(main_path, {}).get(kernel, 0),
                "launches_path": main_path,
                "launches_by_path": {f"{p}_call": counts[kernel]
                                     for p, counts in launches_by_path.items()}}

    kernels = [{
        "name": "qkv_attention",
        "route": "cuda",
        "source": "diffuncertainty_tpu_torch/csrc/qkv_attention.cu",
        "replaces": "diffuncertainty_tpu/ops/pallas_attention.py:38",
        **launches("qkv_attention"),
        "max_abs_err": max(c["max_abs_err"]
                           for c in attn_cases + attn_cases16 + attn_cases168 + width_cases),
        "ms": attn_per["ms"],
        "plain_ms": attn_per["plain_ms"],
        "bound_ms": attn_per["bound_ms"],
        "bound_by": bound_by["bound_by"],
        "library_ms": attn_per["library_ms"],
        "per": f"one {rows}-row unet16 forward (one softmax-path call; a diffusion call is "
               f"{DDIM_STEPS}): " + calls_text(attn_calls),
        **attn_extra,
        "shapes": attn_cases,
        "shapes16": attn_cases16,
        "shapes168": attn_cases168,
        "other_widths": width_cases,
        "ptxas": ptxas.get("qkv_attention", {}),
    }, {
        "name": "group_norm_act",
        "route": "cuda",
        "source": "diffuncertainty_tpu_torch/csrc/group_norm_act.cu",
        "replaces": "diffuncertainty_tpu/ops/pallas_groupnorm.py:32",
        **launches("group_norm_act"),
        "max_abs_err": max(c["max_abs_err"] for c in list(norm_cases.values()) + wide_cases),
        "ms": norm_per["ms"],
        "device_ms": norm_per["device_ms"],
        "plain_ms": norm_per["plain_ms"],
        "bound_ms": norm_per["bound_ms"],
        "bound_by": ("bytes" if norm_per["bound_bytes_ms"] >= norm_per["bound_ops_ms"]
                     else "operations"),
        "library_ms": norm_per["library_ms"],
        "per": f"one {rows}-row unet16 forward: its {len(norm_seen)} GroupNorm sites at the "
               f"bf16 path's shapes and dtypes; a diffusion call is {DDIM_STEPS} forwards",
        "per_diffusion_call": {k: None if v is None else DDIM_STEPS * v
                               for k, v in norm_per.items()},
        **norm_extra,
        "shapes": list(norm_cases.values()),
        "wide_shapes": wide_cases,
        "ptxas": ptxas.get("group_norm_act", {}),
    }]
    extra = ""
    if "ensemble" in paths:
        extra += f" (ensemble member overheads {ens_overheads})"
    if "hrnet" in paths:
        extra += f"; hrnet mean EU {hrnet_eu:.4e}"
    if "multiclass" in paths:
        extra += f"; multiclass path {frames_s:.3f} frames/s"
    log(", ".join(f"{p} path {v:.3f} img/s" for p, v in img_s.items()) + extra
        + f"; quality {quality}")
    log(f"total {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
