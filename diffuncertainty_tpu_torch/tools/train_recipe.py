"""The JAX package's training recipes through the port's trainer, and the
toy-128 (or gta-toy) quality of what they train.

    python3 -m diffuncertainty_tpu_torch.tools.train_recipe \\
        [--model softmax|diffusion|ssn|prob_unet|hrnet|swag|ensemble|multiclass]
        [--variant NAME=TOKEN,TOKEN ...] [--epochs N] [--jobs N]
        [--save-npz DIR]

``recipe_tokens`` is the command line of a recipe
(``tools/train_bench_assets.py::_load_cfg`` of the JAX package: the toy64
groups on the generated toy-128 data, the fixture of seed 1234, batch 16,
ImageNet statistics, bf16, validation and ``last`` every 100 epochs), with
each recipe's network, EU method, seed and epochs (``RECIPES``):

- ``softmax`` (the default): the JAX 16-member recipe's member (seed 2024,
  eu none, 150 epochs, ``assets/ensemble16_quality.json``), scored as those
  members were: one member, no TTA, on the first 32 test images and on all
  256, the EMA and the raw weights;
- ``diffusion``, ``ssn``, ``prob_unet``: ``train_single`` of that family
  (the config's seed, 400 epochs: the recipe of
  ``assets/bench_unet16_toy128_{model}.npz``), its EMA weights scored
  through the family's serving path with the protocol of the asset's record
  (``RECORDS``): 16 DDIM-10 trajectories on the first 32 test images
  (diffusion), 16 draws on all 256 (SSN, prob-U-Net);
- ``hrnet``: hrnet-s, softmax, MC-dropout, 400 epochs (the recipe of
  ``assets/bench_hrnet_s_toy128.npz``); its EMA weights and BatchNorm
  statistics through the HRNet serving path (16 MC-dropout members x TTA in
  one 256-row forward) on the first 32 test images (BENCH_r03's record),
  all 256 reported;
- ``swag``: softmax, SWAG-diag over the last 30 epochs, 400 epochs (the
  recipe of ``assets/bench_unet16_toy128_swag.npz``); the run's moments
  (``tools/bench_assets.py::swag_moments``, what the asset stores) give 16
  members (generator seed 42, scale 1.0, ``swag_draw_members``) in the
  ensemble path (MC-dropout live, TTA, members folded: ``member_chunk``
  "auto"), on all 256 (BENCH_r05's ensemble record);
- ``ensemble``: the 16 seeds of ``assets/ensemble16_quality.json`` (2024 + 37
  i), 150 epochs each, ``--jobs`` runs at once; the 16 EMA weight sets
  stacked into the member-folded sampler with TTA, scored on the first 32
  test images against the record's ``ensemble_quality`` (the images its code
  scored), all 256 reported, and each member alone on the 32;
- ``multiclass``: unet16 softmax + MC-dropout on the gta-toy street scenes,
  48 train frames at 128x128, batch 16, each frame's single mask switched
  afresh (``data/cityscapes.py``), 400 epochs (``train_multiclass`` of the
  JAX tool, which trains through ``Trainer.fit`` rather than the command
  line: here too, in a process of its own); its EMA weights through
  ``tools/multiclass_quality.py`` on the 8 frames of 256x512 against
  PARITY.md's multiclass block.

Each run is a ``python -m diffuncertainty_tpu_torch.train`` process on the
card (multiclass: ``python -m diffuncertainty_tpu_torch.tools.train_recipe
--multiclass-run DIR``). The toy-128 records are held to +- the 16
JAX-trained members' full spread (``SEED_BAND``), the multiclass one to its
bands (``MULTICLASS_BANDS``); a metric outside is listed in the line's
``outside_band``. Each ``--variant`` adds its tokens to the recipe (e.g.
``fp32=trainer.precision=fp32`` or ``s2061=seed=2061``); the variants train
at once. Prints one JSON line per variant. Needs a CUDA device.
``--save-npz DIR`` also writes each run's EMA weights (with the HRNet's
``batch_stats``) as ``DIR/{model}_{variant}.npz`` in the ``assets/`` format
(``tools/bench_weights.py``), float leaves stored at the family's dtype of
the JAX tool (``NPZ_DTYPES``).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..core.checkpoint import load_checkpoint
from ..core.config import load_config
from ..core.params import flax_to_torch, stack_states
from ..models.factory import build_model
from ..sampling.sampler import SamplerSpec, make_sampler
from ..sampling.tta import TTAConfig
from ..train.cli import step_report
from .bench_weights import save_params_npz
from .multiclass_quality import default_data_dir, gta_toy_frames
from .quality import toy128_dataset, toy128_quality_eval

REPO = Path(__file__).resolve().parents[2]

# recipe: the family, network, EU method, seed (None: the config's) and epochs
RECIPES = {
    "softmax": dict(model="softmax", network="unet16", eu="none", seed=2024, epochs=150),
    "diffusion": dict(model="diffusion", network="unet16", eu="none", seed=None, epochs=400),
    "ssn": dict(model="ssn", network="unet16", eu="none", seed=None, epochs=400),
    "prob_unet": dict(model="prob_unet", network="unet16", eu="none", seed=None, epochs=400),
    "hrnet": dict(model="softmax", network="hrnet-s", eu="dropout", seed=None, epochs=400),
    "swag": dict(model="softmax", network="unet16", eu="swag_diag", seed=None, epochs=400),
    "ensemble": dict(model="softmax", network="unet16", eu="none", seed=2024, epochs=150),
}
MULTICLASS_EPOCHS = 400
# storage dtype of a family's npz (``FAMILIES`` and ``train_multiclass`` of the
# JAX tool); the others keep the dtype they were trained at
NPZ_DTYPES = {"ssn": "float16", "prob_unet": "float16", "hrnet": "float16",
              "multiclass": "float16"}
# the seeds of the 16 members of assets/ensemble16_quality.json
ENSEMBLE_SEEDS = tuple(2024 + 37 * i for i in range(16))
# each recipe's record and the test images its protocol holds (None: all
# 256): PARITY.md section 3 (diffusion on the first 32 images, BENCH_r02/r03),
# BENCH_r03's hrnet.quality (32 images), BENCH_r05's ensemble stack (the
# SWAG-diag members), assets/ensemble16_quality.json's ensemble_quality (the
# first 32: the JAX tools/quality.py of its time generated 32 test images,
# the split its member_quality was scored on too)
RECORDS = {
    "diffusion": ({"dice": 0.9583, "ged_bma": 0.0185, "aurc": 0.03304, "ece": 0.01458}, 32),
    "ssn": ({"dice": 0.9462, "ged_bma": 0.0276, "aurc": 0.04918, "ece": 0.00958}, None),
    "prob_unet": ({"dice": 0.9486, "ged_bma": 0.0258, "aurc": 0.04531, "ece": 0.00341}, None),
    "hrnet": ({"dice": 0.9498, "ged_bma": 0.0372, "aurc": 0.0483, "ece": 0.00778}, 32),
    "swag": ({"dice": 0.9484, "ged_bma": 0.0397, "aurc": 0.04406, "ece": 0.00344}, None),
    "ensemble": ({"dice": 0.944, "ged_bma": 0.0591, "aurc": 0.04323, "ece": 0.03105}, 32),
}
# the full spread (max - min) of the 16 JAX-trained members of
# assets/ensemble16_quality.json, the repo's one measured seed-to-seed spread
SEED_BAND = {"dice": 0.0117, "ged_bma": 0.0236, "aurc": 0.00693, "ece": 0.01052}
# PARITY.md's multiclass block and its bands (chip_smoke.py's)
MULTICLASS_RECORD = {"dice_macro": 0.5084, "ged_multiclass": 0.313,
                     "ncc_tu_vs_analytic": 0.3406, "ncc_au_vs_analytic": 0.3389}
MULTICLASS_BANDS = {"dice_macro": 0.01, "ged_multiclass": 0.01,
                    "ncc_tu_vs_analytic": 0.02, "ncc_au_vs_analytic": 0.02}
SAMPLES, DDIM_STEPS, MEMBERS, SWAG_SEED = 16, 10, 16, 42
# the bench's TTA (bench.py, chip_smoke.py::build_path)
TTA = TTAConfig(hflip_p=0.5, rotation_limit=22.5, scale_limit=(-0.2, 0.2))


def recipe_tokens(data_dir, save_dir, *, model: str = "softmax", seed: int | None = None,
                  epochs: int | None = None, hw: int = 128) -> list[str]:
    """The training command line of recipe ``model`` (a key of ``RECIPES``),
    with its seed and epochs unless given."""
    r = RECIPES[model]
    seed = r["seed"] if seed is None else seed
    return ["data=toy64", f"network={r['network']}", f"model={r['model']}",
            f"eu_method={r['eu']}", *([f"seed={seed}"] if seed is not None else []),
            f"data.data_input_dir={data_dir}", "data.batch_size=16",
            f"data.augmentations.height={hw}", f"data.augmentations.width={hw}",
            "data.augmentations.mean=[0.485,0.456,0.406]",
            "data.augmentations.std=[0.229,0.224,0.225]",
            f"trainer.max_epochs={epochs or r['epochs']}", "trainer.precision=bf16",
            "trainer.val_every_n_epochs=100", "ckpt_save_freq.last_every_n_epochs=100",
            f"save_dir={save_dir}"]


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
    """(built model, its serving sampler, config) of a checkpoint's weights
    (with the HRNet's BatchNorm statistics)."""
    saved, cfg, _ = load_checkpoint(ckpt)
    built = build_model(cfg, device=device)
    built.module.load_state_dict(flax_to_torch(saved[weights]))
    return built, make_sampler(built, serving_spec(cfg.model.au_type)), cfg


def score(ckpt: Path, weights: str, num_images: int | None) -> dict:
    """Dice/GED/AURC/ECE of one set of a checkpoint's weights (``params`` or
    ``ema_params``) through its family's serving path."""
    built, sampler, cfg = load_trained(ckpt, weights)
    return toy128_quality_eval(built, sampler, cfg.data, device="cuda", num_images=num_images)


def score_hrnet(ckpt: Path, num_images: int | None, device: str = "cuda") -> dict:
    """The HRNet serving path on a checkpoint's EMA weights and statistics:
    16 MC-dropout members x TTA in one forward."""
    built, _, cfg = load_trained(ckpt, device=device)
    sampler = make_sampler(built, SamplerSpec(n_pred=1, n_members=MEMBERS, tta=True,
                                              tta_config=TTA, member_mode="dropout"))
    return toy128_quality_eval(built, sampler, cfg.data, device=device, num_images=num_images)


def ensemble_path(members: dict, device: str = "cuda", precision: str = "bf16"):
    """(config, built, sampler) of the ensemble path on a member stack: the
    bench's unet16 with MC-dropout live, TTA, the members folded ("auto")."""
    cfg = load_config(data="lidc128", network="unet16", model="softmax", eu_method="dropout",
                      precision=precision)
    built = build_model(cfg, device=device)
    spec = SamplerSpec(n_pred=1, n_members=MEMBERS, tta=True, tta_config=TTA,
                       member_mode="params_stack")
    return cfg, built, make_sampler(built, spec, members=members)


def swag_members(ckpt: Path, device: str = "cuda") -> dict:
    """16 members drawn from a SWAG-diag run's moments as the asset stores
    them (generator seed 42, scale 1.0)."""
    from .bench_assets import swag_draw_members, swag_moments

    saved, _, _ = load_checkpoint(ckpt)
    sw = saved["swag_state"]
    mean, std = swag_moments(flax_to_torch(sw["mean"]), flax_to_torch(sw["sq_mean"]))
    return swag_draw_members(mean, std, torch.Generator(device).manual_seed(SWAG_SEED), MEMBERS)


def score_swag(ckpt: Path, num_images: int | None, device: str = "cuda") -> dict:
    cfg, built, sampler = ensemble_path(swag_members(ckpt, device), device)
    return toy128_quality_eval(built, sampler, cfg.data, device=device, num_images=num_images)


def score_ensemble(ckpts: list[Path], num_images: int | None, device: str = "cuda") -> dict:
    """The members' EMA weights stacked, in the member config's sampler
    (params_stack, TTA, members folded), as the JAX recipe scores them."""
    saved, cfg, _ = load_checkpoint(ckpts[0])
    built = build_model(cfg, device=device)
    stack = stack_states([flax_to_torch(load_checkpoint(c)[0]["ema_params"]) for c in ckpts],
                         built.module)
    spec = SamplerSpec(n_pred=1, n_members=len(ckpts), tta=True, tta_config=TTA,
                       member_mode="params_stack")
    sampler = make_sampler(built, spec, members={k: v.to(device) for k, v in stack.items()})
    return toy128_quality_eval(built, sampler, cfg.data, device=device, num_images=num_images)


def score_multiclass(ckpt: Path, device: str = "cuda") -> dict:
    from .multiclass_quality import gta_toy_quality_eval

    built, _, cfg = load_trained(ckpt, device=device)
    return gta_toy_quality_eval(built, cfg.data, device=device)


def outside_band(model: str, quality: dict) -> dict:
    """The metrics of a recipe's trained quality outside its record +- its
    band: {metric: (value, low, high)}."""
    if model == "multiclass":
        record, band = MULTICLASS_RECORD, MULTICLASS_BANDS
    else:
        record, band = RECORDS[model][0], SEED_BAND
    return {m: (quality[m], record[m] - band[m], record[m] + band[m])
            for m in record if abs(quality[m] - record[m]) > band[m]}


def multiclass_tokens(data_dir, save_dir, epochs: int | None = None) -> list[str]:
    """The multiclass recipe's config tokens (``train_multiclass`` of the JAX
    tool: the gta_toy group, MC-dropout, bf16, validation and ``last`` every
    100 epochs)."""
    return ["data=gta_toy", "network=unet16", "model=softmax", "eu_method=dropout",
            f"data.data_input_dir={data_dir}", f"trainer.max_epochs={epochs or MULTICLASS_EPOCHS}",
            "trainer.precision=bf16", "trainer.val_every_n_epochs=100",
            "ckpt_save_freq.last_every_n_epochs=100", f"save_dir={save_dir}"]


def train_multiclass(tokens: list[str]):
    """``Trainer.fit`` over the gta-toy train frames with freshly switched
    single masks (batch 16, shuffled, the tail dropped), no validation;
    ``tokens`` are the training command's (``device=`` included)."""
    from ..data.cityscapes import CityscapesDataset
    from ..data.loader import BatchLoader
    from ..train.cli import parse_args
    from ..train.loop import Trainer

    cfg, special = parse_args(tokens)
    data_dir = Path(cfg.data.data_input_dir)
    train_ds = CityscapesDataset(data_dir / "splits" / "default" / "firstCycle" / "splits.pkl",
                                 data_dir, split="train", return_all_raters=False)
    trainer = Trainer(cfg, device=special["device"])
    trainer.fit(BatchLoader(train_ds, 16, shuffle=True, drop_last=True), None)
    return trainer


class Runs:
    """Commands run as subprocesses, at most ``jobs`` at once (all at once
    if None) in the order added, each one's output to ``BASE/NAME.log``.
    ``add`` queues a run; ``start`` starts a thread that starts queued runs as
    slots free (and kills one past its timeout); ``wait`` waits for one;
    ``stop`` kills what still runs."""

    def __init__(self, base: Path, jobs: int | None = None):
        import threading

        self.base, self.jobs = Path(base), jobs
        self.pending, self.running, self.done = [], {}, {}
        self.lock = threading.Lock()
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.stopped = False
        self.t0 = None

    def dir(self, name: str) -> Path:
        path = self.base / name
        path.mkdir(parents=True, exist_ok=True)
        return path

    def add(self, name: str, cmd: list[str], timeout: float | None = None) -> None:
        with self.lock:
            self.pending.append((name, cmd, timeout))

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.watcher.start()

    def _watch(self) -> None:
        while not self.stopped:
            with self.lock:
                now = time.perf_counter()
                for name, (proc, out, t0, timeout) in list(self.running.items()):
                    if proc.poll() is None and timeout is not None and now - t0 > timeout:
                        proc.kill()
                        proc.wait()
                    if proc.poll() is not None:
                        out.close()
                        self.done[name] = (proc.returncode, now - t0, now - self.t0)
                        del self.running[name]
                while self.pending and (self.jobs is None or len(self.running) < self.jobs):
                    name, cmd, timeout = self.pending.pop(0)
                    out = open(self.base / f"{name}.log", "w")
                    proc = subprocess.Popen(cmd, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
                    self.running[name] = (proc, out, time.perf_counter(), timeout)
            time.sleep(0.5)

    def wait(self, name: str) -> dict:
        """``{"wall_s", "since_start_s", "output"}`` of a finished run (its
        own wall, and from ``start`` to its end); raises if it failed."""
        while True:
            with self.lock:
                if name in self.done:
                    rc, wall, since = self.done[name]
                    break
                if name not in self.running and all(n != name for n, _, _ in self.pending):
                    raise KeyError(f"no run named {name}")
            time.sleep(0.5)
        text = (self.base / f"{name}.log").read_text()
        if rc != 0:
            raise RuntimeError(f"{name}: exited {rc}:\n{text[-4000:]}")
        return {"wall_s": wall, "since_start_s": since, "output": text}

    def stop(self) -> None:
        self.stopped = True
        with self.lock:
            for proc, out, _, _ in self.running.values():
                proc.kill()
                proc.wait()
                out.close()
            self.running.clear()
            self.pending.clear()


def save_ema_npz(ckpt: Path, path: Path, model: str) -> Path:
    """A run's EMA weights (with the HRNet's ``batch_stats``) as an
    ``assets/``-format npz, float leaves at the family's dtype."""
    return save_params_npz(load_checkpoint(ckpt)[0]["ema_params"], path,
                           dtype=NPZ_DTYPES.get(model))


def step_summary(output: str) -> dict:
    """A trainer's closing ``steps ...`` line and its median step (ms)."""
    (steps,) = [ln for ln in output.splitlines() if ln.startswith("steps ")]
    return {"steps": steps,
            "median_step_ms": float(re.search(r"median step ([0-9.]+) ms", steps).group(1))}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="softmax", choices=(*RECIPES, "multiclass"))
    parser.add_argument("--variant", action="append", default=[],
                        help="NAME=TOKEN,TOKEN: tokens added to the recipe (repeatable)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="the recipe's by default (RECIPES; multiclass 400)")
    parser.add_argument("--jobs", type=int, default=None,
                        help="runs at once (default: all)")
    parser.add_argument("--save-npz", type=Path, default=None, metavar="DIR",
                        help="write each run's EMA weights as DIR/{model}_{variant}.npz")
    parser.add_argument("--multiclass-run", nargs=argparse.REMAINDER, default=None,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.multiclass_run is not None:  # one multiclass run in this process
        print(step_report(train_multiclass(args.multiclass_run)), flush=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("train_recipe needs a CUDA device")
    model = args.model
    tmp = Path(tempfile.mkdtemp())
    if model == "ensemble":
        variants = {f"s{seed}": f"seed={seed}" for seed in ENSEMBLE_SEEDS}
    else:
        variants = dict(v.split("=", 1) for v in args.variant) or {"recipe": ""}
    if model == "multiclass":
        gta_toy_frames(8, (256, 512), 128, 1234)  # generates the data tree (train frames too)
    runs = Runs(tmp, args.jobs)
    for name, tokens in variants.items():
        extra = [t for t in tokens.split(",") if t]
        if model == "multiclass":
            runs.add(name, [sys.executable, "-m", "diffuncertainty_tpu_torch.tools.train_recipe",
                            "--multiclass-run", *multiclass_tokens(
                                default_data_dir(), tmp / name, args.epochs), *extra])
        else:
            runs.add(name, [sys.executable, "-m", "diffuncertainty_tpu_torch.train",
                            *recipe_tokens(toy128_dataset(128).base_dir, tmp / name,
                                           model=model, epochs=args.epochs), *extra])
    runs.start()
    done = {}
    try:
        for name in variants:
            run = runs.wait(name)
            done[name] = {"wall_s": run["since_start_s"], **step_summary(run["output"])}
            print(f"{name}: {done[name]['steps']} ({run['since_start_s']:.1f}s since the start, "
                  f"{len(variants)} runs, {args.jobs or len(variants)} at once)", flush=True)
    finally:
        runs.stop()
    ckpts = {name: next((tmp / name).glob("*/version_0/checkpoints/last")) for name in variants}
    if args.save_npz is not None:
        for name, ckpt in ckpts.items():
            path = save_ema_npz(ckpt, args.save_npz / f"{model}_{name}.npz", model)
            print(f"{name}: EMA weights -> {path}", flush=True)
    device_name = torch.cuda.get_device_name(0)
    if model == "ensemble":
        members = [ckpts[n] for n in variants]
        _, n_images = RECORDS[model]
        q = score_ensemble(members, n_images)
        line = {"model": model, "members": len(variants), "device": device_name,
                "wall_s": max(r["wall_s"] for r in done.values()),
                "median_step_ms": [r["median_step_ms"] for r in done.values()],
                "steps": [r["steps"] for r in done.values()], "jobs": args.jobs,
                "ensemble_quality": q, "images": n_images,
                "ensemble_quality_256": score_ensemble(members, None),
                "member_ema_32": [score(c, "ema_params", 32) for c in members],
                "outside_band": outside_band(model, q)}
        print(json.dumps(line), flush=True)
        return
    for name in variants:
        ckpt = ckpts[name]
        line = {"variant": name, "model": model, "tokens": variants[name],
                "device": device_name, **done[name]}
        if model == "softmax":
            line.update({f"{w}_{n or 256}": score(ckpt, w, n)
                         for w in ("ema_params", "params") for n in (32, None)})
        elif model == "multiclass":
            line["ema_params"] = q = score_multiclass(ckpt)
            line["outside_band"] = outside_band(model, q)
        else:
            _, n_images = RECORDS[model]
            scorer = {"hrnet": score_hrnet, "swag": score_swag}.get(
                model, lambda c, n: score(c, "ema_params", n))
            line["ema_params"] = q = scorer(ckpt, n_images)
            line["images"] = n_images or 256
            line["outside_band"] = outside_band(model, q)
            if n_images:
                line["ema_params_256"] = scorer(ckpt, None)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
