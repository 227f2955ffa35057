"""Device-time breakdown of the main paths on the card.

    python3 -m diffuncertainty_tpu_torch.tools.profile_main_path
        [--workload softmax|diffusion|ssn|prob_unet|ensemble|ensemble_folded|hrnet|multiclass]
        [--norm-twin]

``softmax`` (default): the bf16 unet16 MC-dropout + TTA sampler with the
trained toy-128 weights (16 images at 128x128, 16 members: one 256-row
forward per call), 3 traced calls. ``diffusion``: the bf16 unet16 diffusion
sampler with the trained toy-128 diffusion weights (16 images, 16 DDIM-10
trajectories: ten 256-row forwards per call), 1 traced call. ``ssn`` and
``prob_unet``: the bf16 unet16 SSN and prob-U-Net samplers with their
trained toy-128 weights (16 images, 16 samples: one 16-row forward, then 16
low-rank normal draws or 16 latent decodes, per call), 5 traced calls.
``ensemble``: the bf16 unet16 sampler over 16 stacked members drawn from the
trained SWAG-diag moments (generator seed 42), MC-dropout live and TTA on
(16 images: one 16-row forward per member, 16 per call, ``member_chunk=1``),
3 traced calls; it also prints the device time per member forward.
``ensemble_folded``: the same members in one member-folded 256-row forward
(``member_fold=True``), 3 traced calls. ``hrnet``: the bf16 hrnet-s
MC-dropout (final dropout) + TTA sampler with the trained toy-128 weights (16
images, 16 members: one 256-row forward per call), 3 traced calls.
``multiclass``: the bf16 unet16 multiclass model with the trained gta-toy
weights, 8 MC-dropout members one after another, each one forward of the 168
tiles (window 128, stride 64) of 8 frames of 256x512 and the stitch, 1
traced call; it also prints the device time per member forward. Each is
warmed up first, then traced with ``torch.profiler``. Prints the wall time
per call (CUDA events), the device busy share (:func:`device_ms`: the union
of the kernel intervals over the wall time, beside their plain sum), the
kernel time by category and the top kernels by name. ``--norm-twin`` routes
every GroupNorm through the kernel's plain float32 twin instead, to measure
what the kernel replaced. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..core.config import load_config
from ..core.params import load_into, load_swag_npz
from ..models import unet
from ..models.factory import build_model
from ..ops import cuda_groupnorm
from ..sampling.sampler import SamplerSpec, make_sampler
from ..sampling.tta import TTAConfig
from ..tools.bench_assets import swag_draw_members
from ..tools.multiclass_quality import member_sliding_window_fn

ASSETS = Path(__file__).resolve().parents[2] / "assets"
TOP = 20
# first matching substring of the lowercased kernel name decides the category
CATEGORIES = (
    ("attention kernel", ("qkv_attention",)),
    ("groupnorm kernel", ("group_norm_act",)),
    ("random draws", ("distribution", "philox", "curand")),
    ("cholesky", ("potrf", "cholesky")),
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "fprop", "nhwc")),
    ("matmul", ("gemm", "cutlass", "sm90_")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy/cat/index", ("cat", "copy", "index", "gather", "scatter")),
)


def category(name: str) -> str:
    low = name.lower()
    for label, keys in CATEGORIES:
        if any(k in low for k in keys):
            return label
    return "other"


WORKLOADS = ("softmax", "diffusion", "ssn", "prob_unet", "ensemble", "ensemble_folded", "hrnet",
             "multiclass")
MEMBERS = 16  # member forwards per ensemble call
# member forwards per multiclass call, and its frames
MC_MEMBERS, MC_FRAMES, MC_SIZE = 8, 8, (256, 512)


def build_sampler(workload: str):
    """(sampler, traced calls) of one workload, bf16, trained weights."""
    if workload == "multiclass":
        built = build_model(load_config(data="gta_toy", precision="bf16"), device="cuda")
        load_into(built.module, ASSETS / "bench_unet16_gtatoy_multiclass.npz")
        return member_sliding_window_fn(built.module, window=128, stride=64,
                                        members=MC_MEMBERS), 1
    if workload == "hrnet":
        built = build_model(load_config(network="hrnet-s", precision="bf16"), device="cuda")
        load_into(built.module, ASSETS / "bench_hrnet_s_toy128.npz")
        spec = SamplerSpec(n_pred=1, n_members=16, member_mode="dropout", tta=True,
                           tta_config=TTAConfig())
        return make_sampler(built, spec), 3
    if workload in ("ssn", "prob_unet"):
        built = build_model(load_config(model=workload, eu_method="none", precision="bf16"),
                            device="cuda")
        load_into(built.module, ASSETS / f"bench_unet16_toy128_{workload}.npz")
        return make_sampler(built, SamplerSpec(n_pred=16, n_members=1, member_mode="single")), 5
    if workload == "diffusion":
        built = build_model(load_config(model="diffusion", eu_method="none", precision="bf16"),
                            device="cuda")
        load_into(built.module, ASSETS / "bench_unet16_toy128_diffusion.npz")
        spec = SamplerSpec(n_pred=16, n_members=1, member_mode="single",
                           diffusion_sampler="ddim", diffusion_num_steps=10)
        return make_sampler(built, spec), 1
    built = build_model(load_config(precision="bf16"), device="cuda")
    if workload in ("ensemble", "ensemble_folded"):
        moments = load_swag_npz(ASSETS / "bench_unet16_toy128_swag.npz")
        members = swag_draw_members(moments.mean, moments.std,
                                    torch.Generator("cuda").manual_seed(42), MEMBERS)
        fields = (dict(member_fold=True) if workload == "ensemble_folded"
                  else dict(member_chunk=1))
        spec = SamplerSpec(n_pred=1, n_members=MEMBERS, member_mode="params_stack", tta=True,
                           tta_config=TTAConfig(), **fields)
        return make_sampler(built, spec, members=members), 3
    load_into(built.module, ASSETS / "bench_unet16_toy128.npz")
    spec = SamplerSpec(n_pred=1, n_members=16, member_mode="dropout", tta=True,
                       tta_config=TTAConfig())
    return make_sampler(built, spec), 3


def device_ms(prof, calls: int) -> dict:
    """Device time per call from a ``torch.profiler`` trace: ``busy``, the
    union of the kernel, copy and set intervals (Kineto's user annotations,
    which mirror host ranges onto the device timeline, left out), and
    ``sum``, their durations added; ``sum`` above ``busy`` means intervals
    overlapped (on ``streams`` streams) or were listed twice."""
    spans = sorted((e.time_range.start, e.time_range.end, e.device_resource_id)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    busy, reach = 0.0, float("-inf")
    for start, end, _ in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return {"busy": busy / 1e3 / calls, "sum": sum(e - s for s, e, _ in spans) / 1e3 / calls,
            "streams": len({r for _, _, r in spans})}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", choices=WORKLOADS, default="softmax")
    parser.add_argument("--norm-twin", action="store_true",
                        help="GroupNorm through the plain float32 twin, not the kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")
    if args.norm_twin:
        unet.group_norm_act = cuda_groupnorm.group_norm_act_reference

    sampler, calls = build_sampler(args.workload)
    shape = (MC_FRAMES,) + MC_SIZE + (3,) if args.workload == "multiclass" else (16, 128, 128, 3)
    images = torch.randn(shape, generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    for i in range(2):
        sampler(images, torch.Generator("cuda").manual_seed(100 + i))
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for i in range(calls):
            sampler(images, torch.Generator("cuda").manual_seed(i))
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / calls

    kernels = {}
    for avg in prof.key_averages():
        if avg.device_type != torch.autograd.DeviceType.CUDA or avg.is_user_annotation:
            continue
        kernels[avg.key] = (avg.self_device_time_total / 1e3 / calls,
                            avg.count // calls)
    dev = device_ms(prof, calls)
    busy_ms = dev["busy"]
    by_cat: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms

    print(f"workload {args.workload}{' (GroupNorm through the twin)' if args.norm_twin else ''}; "
          f"device: {torch.cuda.get_device_name(0)}; {calls} traced calls")
    unit = "frames" if args.workload == "multiclass" else "img"
    print(f"wall {wall_ms:.2f} ms per call ({shape[0] / wall_ms * 1e3:.2f} {unit}/s); device "
          f"busy {busy_ms:.2f} ms per call (kernel times summed {dev['sum']:.2f} ms, "
          f"{dev['streams']} streams); busy share {busy_ms / wall_ms:.3f}")
    per_member = {}
    members = {"ensemble": MEMBERS, "multiclass": MC_MEMBERS}.get(args.workload)
    if members:
        per_member = {"member_forward_device_ms": busy_ms / members,
                      "member_forward_wall_ms": wall_ms / members}
        print(f"per member forward: device {busy_ms / members:.3f} ms, wall "
              f"{wall_ms / members:.3f} ms ({members} member forwards per call)")
    if not kernels:
        print("the profiler recorded no device time; only the CUDA-event wall time above holds")
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label:16s} {ms:9.3f} ms  {ms / wall_ms:6.1%} of wall")
    print(f"top {TOP} kernels (ms per call, launches per call):")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[: TOP]:
        print(f"  {ms:9.3f} ms {n:5d}x  [{category(name)}] {name[:110]}")
    print(json.dumps({"workload": args.workload, "norm_twin": args.norm_twin,
                      "wall_ms": wall_ms, "busy_ms": busy_ms, "kernel_sum_ms": dev["sum"],
                      "by_category_ms": by_cat, **per_member,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
