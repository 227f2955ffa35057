"""The JAX package's training recipes through the port's trainer, and the
toy-128 quality of what they train.

    python3 -m diffuncertainty_tpu_torch.tools.train_recipe \\
        [--model softmax|diffusion|ssn|prob_unet] [--variant NAME=TOKEN,TOKEN ...]
        [--epochs N]

``recipe_tokens`` is the command line of a recipe
(``tools/train_bench_assets.py::_load_cfg`` of the JAX package: the toy64
groups on the generated toy-128 data, the fixture of seed 1234, batch 16,
ImageNet statistics, bf16, validation and ``last`` every 100 epochs, eu
none). ``--model softmax`` (the default) is the JAX 16-member recipe's
member (seed 2024, 150 epochs, ``assets/ensemble16_quality.json``), scored
as those members were: one member, no TTA, on the first 32 test images and
on all 256, the EMA and the raw weights. ``--model diffusion|ssn|prob_unet``
is ``train_single`` of that family (the config's seed, 400 epochs: the
recipe of ``assets/bench_unet16_toy128_{model}.npz``), its EMA weights
scored through the family's serving path with the protocol of the asset's
record (``FAMILY_RECORDS``): 16 DDIM-10 trajectories on the first 32 test
images (diffusion), 16 draws on all 256 (SSN, prob-U-Net), and held to the
record +- the 16 JAX-trained members' full spread (``SEED_BAND``). Each
``--variant`` adds its tokens to the recipe (e.g. ``fp32=trainer.precision=fp32``
or ``s2061=seed=2061``); the variants train at once, each in its own
``python -m diffuncertainty_tpu_torch.train`` process on the card. Prints
one JSON line per variant. Needs a CUDA device.
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


# the record of each family's asset (PARITY.md section 3; diffusion on the
# first 32 test images, BENCH_r02/r03) and the images its protocol scores
FAMILY_RECORDS = {
    "diffusion": ({"dice": 0.9583, "ged_bma": 0.0185, "aurc": 0.03304, "ece": 0.01458}, 32),
    "ssn": ({"dice": 0.9462, "ged_bma": 0.0276, "aurc": 0.04918, "ece": 0.00958}, None),
    "prob_unet": ({"dice": 0.9486, "ged_bma": 0.0258, "aurc": 0.04531, "ece": 0.00341}, None),
}
# the full spread (max - min) of the 16 JAX-trained members of
# assets/ensemble16_quality.json, the repo's one measured seed-to-seed spread
SEED_BAND = {"dice": 0.0117, "ged_bma": 0.0236, "aurc": 0.00693, "ece": 0.01052}
SAMPLES, DDIM_STEPS = 16, 10


def recipe_tokens(data_dir, save_dir, *, model: str = "softmax", seed: int | None = None,
                  epochs: int | None = None, hw: int = 128) -> list[str]:
    """The training command line of a recipe: the softmax member (seed 2024,
    150 epochs by default) or ``train_single`` of a generative family (the
    config's seed, 400 epochs by default)."""
    if model == "softmax":
        seed = 2024 if seed is None else seed
    epochs = epochs or (150 if model == "softmax" else 400)
    return ["data=toy64", "network=unet16", f"model={model}", "eu_method=none",
            *([f"seed={seed}"] if seed is not None else []),
            f"data.data_input_dir={data_dir}", "data.batch_size=16",
            f"data.augmentations.height={hw}", f"data.augmentations.width={hw}",
            "data.augmentations.mean=[0.485,0.456,0.406]",
            "data.augmentations.std=[0.229,0.224,0.225]", f"trainer.max_epochs={epochs}",
            "trainer.precision=bf16", "trainer.val_every_n_epochs=100",
            "ckpt_save_freq.last_every_n_epochs=100", f"save_dir={save_dir}"]


def serving_spec(model: str) -> SamplerSpec:
    """The sampler of a family's serving path: one member, no TTA (softmax),
    16 DDIM-10 trajectories (diffusion), 16 draws (SSN, prob-U-Net)."""
    if model == "softmax":
        return SamplerSpec(n_pred=1, n_members=1, member_mode="single")
    if model == "diffusion":
        return SamplerSpec(n_pred=SAMPLES, n_members=1, member_mode="single",
                           diffusion_sampler="ddim", diffusion_num_steps=DDIM_STEPS)
    return SamplerSpec(n_pred=SAMPLES, n_members=1, member_mode="single")


def load_trained(ckpt: Path, weights: str = "ema_params", device: str = "cuda"):
    """(built model, its serving sampler, config) of a checkpoint's weights."""
    saved, cfg, _ = load_checkpoint(ckpt)
    built = build_model(cfg, device=device)
    built.module.load_state_dict(flax_to_torch(saved[weights]))
    return built, make_sampler(built, serving_spec(cfg.model.au_type)), cfg


def score(ckpt: Path, weights: str, num_images: int | None) -> dict:
    """Dice/GED/AURC/ECE of one set of a checkpoint's weights (``params`` or
    ``ema_params``) through its family's serving path."""
    built, sampler, cfg = load_trained(ckpt, weights)
    return toy128_quality_eval(built, sampler, cfg.data, device="cuda", num_images=num_images)


def outside_band(model: str, quality: dict) -> dict:
    """The metrics of a family's trained quality outside its record +- the
    JAX members' spread: {metric: (value, low, high)}."""
    record, _ = FAMILY_RECORDS[model]
    return {m: (quality[m], record[m] - SEED_BAND[m], record[m] + SEED_BAND[m])
            for m in record if abs(quality[m] - record[m]) > SEED_BAND[m]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="softmax",
                        choices=("softmax", "diffusion", "ssn", "prob_unet"))
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=TOKEN,TOKEN: tokens added to the recipe (repeatable)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="150 for softmax, 400 for the other families")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_recipe needs a CUDA device")
    variants = dict(v.split("=", 1) for v in args.variant) or {"recipe": ""}
    data_dir = toy128_dataset(128).base_dir
    tmp = Path(tempfile.mkdtemp())
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "diffuncertainty_tpu_torch.train",
         *recipe_tokens(data_dir, tmp / name, model=args.model, epochs=args.epochs),
         *[t for t in tokens.split(",") if t]],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, tokens in variants.items()}
    walls = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        walls[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise SystemExit(f"{name}: the trainer exited {proc.returncode}:\n{out[-3000:]}")
        steps = [ln for ln in out.splitlines() if ln.startswith("steps ")]
        print(f"{name}: {steps} ({walls[name]:.1f}s since the start, "
              f"{len(procs)} runs at once)", flush=True)
    for name in variants:
        (ckpt,) = (tmp / name).glob("*/version_0/checkpoints/last")
        line = {"variant": name, "model": args.model, "tokens": variants[name],
                "device": torch.cuda.get_device_name(0), "wall_s": walls[name]}
        if args.model == "softmax":
            line.update({f"{w}_{n or 256}": score(ckpt, w, n)
                         for w in ("ema_params", "params") for n in (32, None)})
        else:
            _, n_images = FAMILY_RECORDS[args.model]
            line["ema_params"] = q = score(ckpt, "ema_params", n_images)
            line["images"] = n_images or 256
            line["outside_band"] = outside_band(args.model, q)
            if n_images:
                line["ema_params_256"] = score(ckpt, "ema_params", None)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
