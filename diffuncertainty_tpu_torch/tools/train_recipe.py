"""The JAX 16-member recipe's training run through the port's trainer, and the
toy-128 quality of what it trains.

    python3 -m diffuncertainty_tpu_torch.tools.train_recipe \\
        [--variant NAME=TOKEN,TOKEN ...] [--epochs 150]

``recipe_tokens`` is the command line of the recipe's member
(``tools/train_bench_assets.py::_load_cfg`` of the JAX package: the toy64
groups on the generated toy-128 data, batch 16, ImageNet statistics, bf16,
seed 2024, eu none). Each ``--variant`` adds its tokens to it (e.g.
``fp32=trainer.precision=fp32`` or ``s2061=seed=2061``); the variants train
at once, each in its own ``python -m diffuncertainty_tpu_torch.train``
process on the card, and the EMA and the raw weights of each ``last``
checkpoint are scored as the JAX members were (one member, no TTA) on the
first 32 test images and on all 256. Prints one JSON line per variant.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..core.checkpoint import load_checkpoint
from ..core.params import flax_to_torch
from ..models.factory import build_model
from ..sampling.sampler import SamplerSpec, make_sampler
from .quality import toy128_dataset, toy128_quality_eval

REPO = Path(__file__).resolve().parents[2]


def recipe_tokens(data_dir, save_dir, *, seed: int = 2024, epochs: int = 150,
                  hw: int = 128) -> list[str]:
    """The training command line of the JAX recipe's member."""
    return ["data=toy64", "network=unet16", "model=softmax", "eu_method=none", f"seed={seed}",
            f"data.data_input_dir={data_dir}", "data.batch_size=16",
            f"data.augmentations.height={hw}", f"data.augmentations.width={hw}",
            "data.augmentations.mean=[0.485,0.456,0.406]",
            "data.augmentations.std=[0.229,0.224,0.225]", f"trainer.max_epochs={epochs}",
            "trainer.precision=bf16", "trainer.val_every_n_epochs=100",
            "ckpt_save_freq.last_every_n_epochs=100", f"save_dir={save_dir}"]


def score(ckpt: Path, weights: str, num_images: int | None) -> dict:
    """Dice/GED/AURC/ECE of one set of a checkpoint's weights (``params`` or
    ``ema_params``): one member, no TTA."""
    saved, cfg, _ = load_checkpoint(ckpt)
    built = build_model(cfg, device="cuda")
    built.module.load_state_dict(flax_to_torch(saved[weights]))
    sampler = make_sampler(built, SamplerSpec(n_pred=1, n_members=1, member_mode="single"))
    return toy128_quality_eval(built, sampler, cfg.data, device="cuda", num_images=num_images)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=TOKEN,TOKEN: tokens added to the recipe (repeatable)")
    parser.add_argument("--epochs", type=int, default=150)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_recipe needs a CUDA device")
    variants = dict(v.split("=", 1) for v in args.variant) or {"recipe": ""}
    data_dir = toy128_dataset(128).base_dir
    tmp = Path(tempfile.mkdtemp())
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "diffuncertainty_tpu_torch.train",
         *recipe_tokens(data_dir, tmp / name, epochs=args.epochs),
         *[t for t in tokens.split(",") if t]],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, tokens in variants.items()}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: the trainer exited {proc.returncode}:\n{out[-3000:]}")
        steps = [ln for ln in out.splitlines() if ln.startswith("steps ")]
        print(f"{name}: {steps} ({time.perf_counter() - t0:.1f}s since the start, "
              f"{len(procs)} runs at once)", flush=True)
    for name in variants:
        (ckpt,) = (tmp / name).glob("*/version_0/checkpoints/last")
        print(json.dumps({"variant": name, "tokens": variants[name],
                          "device": torch.cuda.get_device_name(0),
                          **{f"{w}_{n or 256}": score(ckpt, w, n)
                             for w in ("ema_params", "params") for n in (32, None)}}),
              flush=True)


if __name__ == "__main__":
    main()
