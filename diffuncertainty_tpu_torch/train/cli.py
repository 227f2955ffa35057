"""The training command (port of ``diffuncertainty_tpu/train/cli.py``).

    python -m diffuncertainty_tpu_torch.train data=toy64 network=unet16 \\
        model=softmax eu_method=none trainer.max_epochs=150 \\
        data.data_input_dir=/path/to/data [device=cpu]

Group selections (``data= network= model= eu_method=``) pick the config
groups; every other ``a.b=c`` token is a dotted override, its value read as
YAML. ``DATASET_LOCATION`` / ``EXPERIMENT_LOCATION`` relocate the data and
save directories, ``LSB_JOBID`` names the run's version when none is set.
``resume_from=<checkpoint>`` restores the full state of a ``last``
checkpoint and goes on at the next epoch; ``ckpt_path=<checkpoint>`` loads
its weights with a fresh optimizer. The port adds ``device=`` (``cuda`` by
default, ``cpu`` when asked); without a card it raises, never falling back.
Checkpoints are the port's (``core/checkpoint.py``), in the flax key layout,
which ``python -m diffuncertainty_tpu_torch.infer`` reads.

Data parallel: start one process per card with ``DU_COORDINATOR``,
``DU_NUM_PROCESSES`` and ``DU_PROCESS_ID`` set (or under ``torchrun``) and
``trainer.mesh_shape=[D,1]``; ``parallel/distributed.py::
initialize_distributed`` joins them, each rank loads its strided shard of
every epoch (``loader_shard``, ``data.batch_size`` rows a rank, as the JAX
trainer's per-process batch), and the primary rank logs and checkpoints.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

from ..core.checkpoint import load_checkpoint
from ..core.config import ExperimentConfig, apply_overrides, load_config
from ..data.dataset import MultiRaterDataset, load_splits
from ..data.loader import BatchLoader
from ..parallel.distributed import initialize_distributed, is_primary, loader_shard
from .loop import Trainer

USAGE = __doc__.split("\n\n")[1]


def parse_args(argv: list[str]) -> tuple[ExperimentConfig, dict]:
    """(config, special): ``special`` holds ``resume_from``, ``ckpt_path``
    and ``device``."""
    groups = {"data": "lidc64", "network": "unet16", "model": "softmax", "eu_method": "none"}
    special: dict = {"resume_from": None, "ckpt_path": None, "device": "cuda"}
    overrides = []
    for tok in argv:
        if tok in ("-h", "--help"):
            print(USAGE)
            raise SystemExit(0)
        if "=" not in tok:
            raise SystemExit(f"Arguments must be key=value, got '{tok}'")
        key, val = tok.split("=", 1)
        if key in groups:
            groups[key] = val
        elif key in special:
            special[key] = val
        else:
            overrides.append(tok)
    cfg = load_config(**groups, overrides=overrides)
    if os.environ.get("DATASET_LOCATION"):
        cfg = apply_overrides(
            cfg, [f"data.data_input_dir={os.environ['DATASET_LOCATION']}/{cfg.data.name}"])
    if os.environ.get("EXPERIMENT_LOCATION"):
        cfg = apply_overrides(cfg, [f"save_dir={os.environ['EXPERIMENT_LOCATION']}"])
    if cfg.version is None and os.environ.get("LSB_JOBID"):
        cfg = apply_overrides(cfg, [f"version={os.environ['LSB_JOBID']}"])
    return cfg, special


def build_loaders(cfg: ExperimentConfig, mesh=None):
    """(train, val, train_eval) loaders: the shuffled train split (one random
    rater per image, the tail dropped; with a ``mesh``, this rank's shard of
    it), the val split with every rater, or ``validation_ratio`` of the train
    split carved off when the fold has no val split, and with
    ``evaluate_training_data`` a random val-sized subset of the train
    split."""
    data_dir = Path(cfg.data.data_input_dir)
    splits_path = cfg.data.splits_path or (
        data_dir / "splits" / cfg.data.split_name / "firstCycle" / "splits.pkl")
    fold_id = cfg.data.data_fold_id

    def dataset(split, all_raters):
        return MultiRaterDataset(splits_path, data_dir, split=split, data_fold_id=fold_id,
                                 return_all_raters=all_raters,
                                 single_rater=cfg.data.single_rater and not all_raters)

    train_ds = dataset("train", False)
    if "val" in load_splits(splits_path)[fold_id]:
        val_ds = dataset("val", True)
    else:
        val_ds = dataset("train", True)
        n = len(train_ds)
        n_val = max(1, int(round(n * cfg.data.validation_ratio)))
        val_idx = set(np.random.default_rng(cfg.seed).choice(n, n_val, replace=False).tolist())
        val_ds.subset(val_idx)
        train_ds.subset(set(range(n)) - val_idx)
    train_loader = BatchLoader(train_ds, cfg.data.batch_size, shuffle=True, seed=cfg.seed,
                               drop_last=True, process_shard=loader_shard(mesh))
    val_loader = BatchLoader(val_ds, cfg.data.val_batch_size, drop_last=False)
    train_eval_loader = None
    if cfg.data.evaluate_training_data:
        mirror = dataset("train", True)
        train_ids = set(train_ds.image_ids)
        candidates = [i for i, iid in enumerate(mirror.image_ids) if iid in train_ids]
        n_keep = min(max(1, len(val_ds)), len(candidates))
        rng = np.random.default_rng((cfg.seed, 17))
        mirror.subset({int(i) for i in rng.choice(candidates, n_keep, replace=False)})
        train_eval_loader = BatchLoader(mirror, cfg.data.val_batch_size, drop_last=False)
    return train_loader, val_loader, train_eval_loader


def step_report(trainer: Trainer) -> str:
    """The closing line: steps, median step (host wall), img/s and, on the
    card, peak memory."""
    ms = float(np.median(trainer.step_seconds)) * 1e3
    line = (f"steps {len(trainer.step_seconds)}, median step {ms:.3f} ms "
            f"({trainer.cfg.data.batch_size / ms * 1e3:.2f} img/s)")
    if trainer.device.type == "cuda":
        import torch

        line += f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
    return line


def main(argv: list[str] | None = None) -> Trainer:
    cfg, special = parse_args(argv if argv is not None else sys.argv[1:])
    # the rendezvous first: a no-op unless a coordinator is configured
    initialize_distributed(device=special["device"])
    say = print if is_primary() else (lambda *a, **k: None)
    say(f"Experiment: {cfg.auto_exp_name} (seed {cfg.seed}) on {special['device']}", flush=True)
    trainer = Trainer(cfg, device=special["device"])
    train_loader, val_loader, train_eval_loader = build_loaders(cfg, trainer.mesh)
    resume_state, start_epoch = None, 0
    if special["resume_from"]:
        saved, _, meta = load_checkpoint(special["resume_from"])
        resume_state = trainer.restore_state(saved)
        start_epoch = int(meta["epoch"]) + 1
        say(f"Resuming from epoch {start_epoch}", flush=True)
    elif special["ckpt_path"]:
        from ..core.params import flax_to_torch

        saved, _, _ = load_checkpoint(special["ckpt_path"])
        resume_state = trainer.init_state()  # the EMA starts as a copy of the initial weights
        # in place: the state's parameters are the module's
        trainer.built.module.load_state_dict(
            flax_to_torch(saved.get("params", saved.get("ema_params"))), strict=True)
        say("Loaded weights (fresh optimizer state)", flush=True)
    trainer.fit(train_loader, val_loader, train_eval_loader=train_eval_loader,
                resume_state=resume_state, start_epoch=start_epoch)
    if trainer.step_seconds:
        say(step_report(trainer), flush=True)
    say(f"Done. Checkpoints at {trainer.workdir / 'checkpoints'}", flush=True)
    return trainer
