"""The uncertainty-inference command (port of ``diffuncertainty_tpu/infer/cli.py``).

Checkpoint paths (glob wildcards allowed) expand into jobs, one per
checkpoint group x EMA mode, each run over every test split;
``--ensemble_mode`` groups all checkpoints into one deep-ensemble job. The
checkpoints are the port's (``export_torch_checkpoint.py`` writes one from a
JAX checkpoint).

    python -m diffuncertainty_tpu_torch.infer \\
        --checkpoint_paths saves/exp/v0/checkpoints/last \\
        --test_split id ood_noise --n_pred 10 --n_models 10 --tta [--device cpu]
        [--member_chunk auto|none|N] [--same_dropout] [--include_eval]

Runs on the card unless ``--device cpu`` is given. Prints one summary dict
per split (images, seconds, images_per_sec, out_dir). ``--include_eval``
then runs ``evaln/runner.py::run_default_evaluation`` over each split of the
job (on the host).

Several ranks: start one process per card with ``DU_COORDINATOR``,
``DU_NUM_PROCESSES`` and ``DU_PROCESS_ID`` set (or under ``torchrun``);
``parallel/distributed.py::initialize_distributed`` joins them, and
``--mesh_shape DATA MEMBER`` (default: the JAX job's auto choice) lays the
job out over them. The primary rank prints, evaluates and writes.
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

from ..parallel.distributed import initialize_distributed, is_primary
from .runner import InferenceConfig, UncertaintyInference


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Uncertainty inference (PyTorch port)")
    p.add_argument("--checkpoint_paths", nargs="+", required=True,
                   help="checkpoint dirs; glob wildcards allowed")
    p.add_argument("--test_split", nargs="+", default=["id"])
    p.add_argument("--n_pred", type=int, default=10)
    p.add_argument("--n_models", type=int, default=10)
    p.add_argument("--tta", action="store_true")
    p.add_argument("--same_dropout", action="store_true",
                   help="one dropout draw per member, reused by all its samples")
    p.add_argument("--member_chunk", type=_member_chunk, default="auto",
                   help="members per forward: auto (default), none (all) or an int")
    p.add_argument("--discretize", action="store_true")
    p.add_argument("--direct_au", dest="direct_au", action="store_true")
    p.add_argument("--ema_mode", choices=["true", "false", "both"], default="false")
    p.add_argument("--ensemble_mode", action="store_true",
                   help="treat all checkpoints as one deep ensemble")
    p.add_argument("--metrics_compute", nargs="+", default=["dice", "ged", "ged_bma"])
    p.add_argument("--metrics_only", action="store_true",
                   help="skip writing PNG/TIFF outputs")
    p.add_argument("--skip_existing", action="store_true")
    p.add_argument("--no_likelihood", action="store_true")
    p.add_argument("--diffusion-num-steps", type=int, default=None)
    p.add_argument("--diffusion-sampler", choices=["ddpm", "ddim"], default=None)
    p.add_argument("--swag_scale", type=float, default=1.0)
    p.add_argument("--test_batch_size", type=int, default=16)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--version", default=None)
    p.add_argument("--include_eval", action="store_true",
                   help="run the default evaluation chain over each split after testing")
    p.add_argument("--mesh_shape", type=int, nargs=2, default=None, metavar=("DATA", "MEMBER"),
                   help="(data, member) mesh of the ranks (one per card); default: the "
                        "largest usable factorization of the world size")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _member_chunk(text: str) -> int | str | None:
    if text in ("auto", "none"):
        return None if text == "none" else text
    if not text.isdigit() or int(text) < 1:
        raise argparse.ArgumentTypeError(f"member_chunk takes auto, none or an int >= 1, "
                                         f"got {text!r}")
    return int(text)


def expand_checkpoints(patterns: list[str]) -> list[Path]:
    paths: list[Path] = []
    for pat in patterns:
        matches = sorted(glob.glob(pat)) if any(ch in pat for ch in "*?[") else [pat]
        if not matches:
            raise FileNotFoundError(f"No checkpoints match '{pat}'")
        paths.extend(Path(m) for m in matches)
    return paths


def prepare_jobs(args) -> list[dict]:
    """Cartesian product of (checkpoint group) x EMA modes, each over the splits."""
    ckpts = expand_checkpoints(args.checkpoint_paths)
    groups = [ckpts] if args.ensemble_mode else [[c] for c in ckpts]
    ema_modes = {"true": [True], "false": [False], "both": [False, True]}[args.ema_mode]
    return [{"checkpoints": group, "use_ema": use_ema, "splits": list(args.test_split),
             "version": args.version or _auto_version(group)}
            for group in groups for use_ema in ema_modes]


def _auto_version(group: list[Path]) -> str:
    """``aug0_s12[0,1,2]``-style name from checkpoint parent dirs."""
    names = [p.parent.parent.name for p in group]  # .../<version>/checkpoints/<name>
    if len(set(names)) == 1:
        return names[0]
    return f"{names[0]}[{','.join(str(i) for i in range(len(names)))}]"


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    initialize_distributed(device=args.device)
    summaries = []
    for job in prepare_jobs(args):
        icfg = InferenceConfig(
            n_pred=args.n_pred, n_models=args.n_models, tta=args.tta,
            same_dropout=args.same_dropout, discretize=args.discretize,
            direct_au=args.direct_au, use_ema=job["use_ema"], batch_size=args.test_batch_size,
            seed=args.seed, metrics_compute=tuple(args.metrics_compute),
            save_likelihood=not args.no_likelihood, save_outputs=not args.metrics_only,
            skip_existing=args.skip_existing, diffusion_num_steps=args.diffusion_num_steps,
            diffusion_sampler=args.diffusion_sampler, swag_scale=args.swag_scale,
            data_input_dir=args.data_dir, save_dir=args.save_dir, version=job["version"],
            member_chunk=args.member_chunk,
            mesh_shape=tuple(args.mesh_shape) if args.mesh_shape else None,
            device=args.device)
        runner = UncertaintyInference(job["checkpoints"], icfg)
        for split in job["splits"]:
            summary = runner.run_split(split)
            summary["version"] = job["version"]
            summary["use_ema"] = job["use_ema"]
            if is_primary():
                print(summary, flush=True)
            summaries.append(summary)
        if args.include_eval and is_primary():
            from ..evaln.runner import run_default_evaluation

            for split in job["splits"]:
                run_default_evaluation(runner.split_dir(split), runner.cfg)
    return summaries
