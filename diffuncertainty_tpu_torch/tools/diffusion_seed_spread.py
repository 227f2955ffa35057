"""The seed spread of the diffusion path's quality on the card.

    python3 -m diffuncertainty_tpu_torch.tools.diffusion_seed_spread \\
        [--seed-bases 777 1000 2000 3000 4000] [--precisions bf16 fp32] [--num-images 32]

The trained diffusion asset (``assets/bench_unet16_toy128_diffusion.npz``)
serves 16 DDIM-10 trajectories an image, as ``bench.py``'s diffusion path
does, and ``tools/quality.py::toy128_quality_eval`` scores the first
``--num-images`` images of the toy-128 ``id`` split once a seed base (batch
``bi`` draws from a generator seeded ``seed_base + bi``). Prints the card's
name and power limit, then one JSON line a (precision, seed base).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from ..core.config import load_config
from ..core.params import load_into
from ..models.factory import build_model
from ..sampling.sampler import SamplerSpec, make_sampler
from .quality import toy128_quality_eval

ASSET = Path(__file__).resolve().parents[2] / "assets" / "bench_unet16_toy128_diffusion.npz"


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed-bases", type=int, nargs="+", default=[777, 1000, 2000, 3000, 4000])
    ap.add_argument("--precisions", nargs="+", default=["bf16", "fp32"],
                    choices=("bf16", "fp32"))
    ap.add_argument("--num-images", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the seed spread is measured on the card; torch.cuda.is_available() "
                           "is False")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rows = []
    for precision in args.precisions:
        cfg = load_config(data="lidc128", network="unet16", model="diffusion", eu_method="none",
                          precision=precision)
        built = build_model(cfg, device="cuda")
        load_into(built.module, ASSET)
        sampler = make_sampler(built, SamplerSpec(
            n_pred=16, n_members=1, member_mode="single", diffusion_sampler="ddim",
            diffusion_num_steps=10))
        for seed_base in args.seed_bases:
            t0 = time.perf_counter()
            q = toy128_quality_eval(built, sampler, cfg.data, device="cuda",
                                    num_images=args.num_images, seed_base=seed_base)
            rows.append({"precision": precision, "seed_base": seed_base,
                         "s": round(time.perf_counter() - t0, 2), **q})
            print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
