"""Device-time breakdown of the main paths on the card.

    python3 -m diffuncertainty_tpu_torch.tools.profile_main_path [--workload diffusion] [--norm-twin]

``softmax`` (default): the bf16 unet16 MC-dropout + TTA sampler with the
trained toy-128 weights (16 images at 128x128, 16 members: one 256-row
forward per call), 3 traced calls. ``diffusion``: the bf16 unet16 diffusion
sampler with the trained toy-128 diffusion weights (16 images, 16 DDIM-10
trajectories: ten 256-row forwards per call), 1 traced call. Each is warmed
up first, then traced with ``torch.profiler``. Prints the wall time per call
(CUDA events), the device busy share (the sum of kernel times over the wall
time; kernels on one stream do not overlap), the kernel time by category and
the top kernels by name. ``--norm-twin`` routes every GroupNorm through the
kernel's plain float32 twin instead, to measure what the kernel replaced.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..core.config import load_config
from ..core.params import load_into
from ..models import unet
from ..models.factory import build_model
from ..ops import cuda_groupnorm
from ..sampling.sampler import SamplerSpec, make_sampler
from ..sampling.tta import TTAConfig

ASSETS = Path(__file__).resolve().parents[2] / "assets"
TOP = 20
# first matching substring of the lowercased kernel name decides the category
CATEGORIES = (
    ("attention kernel", ("qkv_attention",)),
    ("groupnorm kernel", ("group_norm_act",)),
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


def build_sampler(workload: str):
    """(sampler, traced calls) of one workload, bf16, trained weights."""
    if workload == "diffusion":
        built = build_model(load_config(model="diffusion", eu_method="none", precision="bf16"),
                            device="cuda")
        load_into(built.module, ASSETS / "bench_unet16_toy128_diffusion.npz")
        spec = SamplerSpec(n_pred=16, n_members=1, member_mode="single",
                           diffusion_sampler="ddim", diffusion_num_steps=10)
        return make_sampler(built, spec), 1
    built = build_model(load_config(precision="bf16"), device="cuda")
    load_into(built.module, ASSETS / "bench_unet16_toy128.npz")
    spec = SamplerSpec(n_pred=1, n_members=16, member_mode="dropout", tta=True,
                       tta_config=TTAConfig())
    return make_sampler(built, spec), 3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", choices=("softmax", "diffusion"), default="softmax")
    parser.add_argument("--norm-twin", action="store_true",
                        help="GroupNorm through the plain float32 twin, not the kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")
    if args.norm_twin:
        unet.group_norm_act = cuda_groupnorm.group_norm_act_reference

    sampler, calls = build_sampler(args.workload)
    images = torch.randn((16, 128, 128, 3), generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
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
        if avg.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels[avg.key] = (avg.self_device_time_total / 1e3 / calls,
                            avg.count // calls)
    busy_ms = sum(ms for ms, _ in kernels.values())
    by_cat: dict[str, float] = {}
    for name, (ms, _) in kernels.items():
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms

    print(f"workload {args.workload}{' (GroupNorm through the twin)' if args.norm_twin else ''}; "
          f"device: {torch.cuda.get_device_name(0)}; {calls} traced calls")
    print(f"wall {wall_ms:.2f} ms per call ({16 / wall_ms * 1e3:.2f} img/s); kernel time "
          f"{busy_ms:.2f} ms per call; busy share {busy_ms / wall_ms:.3f}")
    if not kernels:
        print("the profiler recorded no device time; only the CUDA-event wall time above holds")
    for label, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {label:16s} {ms:9.3f} ms  {ms / wall_ms:6.1%} of wall")
    print(f"top {TOP} kernels (ms per call, launches per call):")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[: TOP]:
        print(f"  {ms:9.3f} ms {n:5d}x  [{category(name)}] {name[:110]}")
    print(json.dumps({"workload": args.workload, "norm_twin": args.norm_twin,
                      "wall_ms": wall_ms, "busy_ms": busy_ms,
                      "by_category_ms": by_cat, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
