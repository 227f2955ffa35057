"""Run the ValUES validation study end to end on the controlled toy environment
(port of ``diffuncertainty_tpu/tools/values_study.py``).

The framework's reason to exist: validate uncertainty methods, the (C1
prediction model = AU type) x (EU method) matrix, on the downstream tasks,
with seed-grouped conclusions. One entry point drives the whole study:

1. generate the controlled toy dataset (known aleatoric ambiguity via rater
   threshold jitter, known OoD shifts, an unlabeled AL pool);
2. train the AU x EU x seed training matrix briefly (``eu=ensemble`` cells
   train ``n_models`` independently-seeded members each, seeds
   ``1000 * (seed + 1) + m``, grouped at test time);
3. run uncertainty inference per version on id / val / ood splits;
4. evaluate the full task set through ``EvalMatrix`` (threshold, area,
   aggregation, paired OoD detection, failure detection, ambiguity,
   calibration);
5. run one active-learning arm (uncertainty vs random vs worst queries,
   second-cycle retraining, ``al_improvement`` both directions);
6. write the seed-grouped ds-task table (CSV + LaTeX), the rank table, the
   figures (``evaln/visualization.py``: charts as JSON, image panels as
   PNG), a summary JSON with direction-of-effect checks and ``REPORT.md``.

Everything runs on ``--device`` (``cuda`` unless ``cpu`` is asked for; with
no card ``cuda`` raises). A re-run reuses the finished cells of its
workdir: a cell's ``last`` checkpoint that reached the final epoch is kept,
a stale one is retrained, and one whose ``meta.json`` cannot be read stops
the study with its path (nothing is deleted). ``summary.json`` adds to the
JAX package's keys the walls of this invocation: per cell its training,
inference and evaluation, and the AL arm's and the report's.

Usage:
    python -m diffuncertainty_tpu_torch.tools.values_study /tmp/values_study \
        [--quick] [--epochs N] [--seeds 0 1] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Sequence

import numpy as np

TASKS = ["threshold", "area", "aggregation", "ood_detection", "failure_detection",
         "ambiguity_modeling", "calibration"]


@dataclasses.dataclass
class StudyConfig:
    workdir: Path
    au_types: tuple[str, ...] = ("softmax", "ssn", "diffusion", "prob_unet")
    eu_methods: tuple[str, ...] = ("none", "dropout", "swag")
    seeds: tuple[int, ...] = (0, 1)
    epochs: int = 6
    n_pred: int = 4
    n_models: int = 4
    image_size: int = 32
    ambiguity: float = 0.15  # toy rater-threshold jitter (data/toy.py)
    num_train: int = 24
    num_val: int = 8
    num_test: int = 16
    num_ood: int = 16
    num_unlabeled: int = 12
    batch_size: int = 8
    diffusion_num_steps: int = 5
    al_arm: tuple[str, str] | None = ("softmax", "dropout")  # (au, eu) or None
    ood_shifts: tuple[str, ...] = ("ood_noise", "ood_blur")
    model_channels: int = 8
    # validate every N training epochs (the metrics and the Platt fit use
    # the inference val split, not training-val)
    val_every: int = 1
    device: str = "cuda"
    # the trainer's metric loggers (None: the config's own)
    loggers: tuple[str, ...] | None = None


SMALL_NET = [
    "network.model_channels={ch}",
    "network.num_res_blocks=[1,1]",
    "network.channel_mult=[1,2]",
    "network.attention_resolutions=[-1]",
    "model.n_aleatoric_samples=4",
    "trainer.learning_rate=0.003",
]


def _method_name(au: str, eu: str) -> str:
    return f"{au}_{eu}"


def _load_run_config(scfg: StudyConfig, toy: Path, au: str, eu: str, seed: int,
                     version: str | None = None, train_seed: int | None = None):
    from ..core.config import load_config

    overrides = [o.format(ch=scfg.model_channels) for o in SMALL_NET] + [
        f"trainer.max_epochs={scfg.epochs}",
        f"trainer.val_every_n_epochs={scfg.val_every}",
        f"data.batch_size={scfg.batch_size}",
        f"save_dir={scfg.workdir / 'saves'}",
        f"data.data_input_dir={toy}",
        "data.split_name=default",
        f"exp_name={_method_name(au, eu)}",
        f"version={version or f's{seed}'}",
        f"seed={train_seed if train_seed is not None else seed}",
    ]
    if scfg.loggers is not None:
        overrides.append(f"trainer.loggers=[{','.join(scfg.loggers)}]")
    return load_config(
        data="toy64", network="unet4", model=au, eu_method=eu, overrides=overrides
    )


def _finished_epoch(last: Path) -> int:
    """The epoch a ``last`` checkpoint reached; its ``meta.json`` must read."""
    meta = last / "meta.json"
    try:
        return int(json.loads(meta.read_text())["epoch"])
    except (OSError, ValueError, KeyError, TypeError) as exc:
        raise RuntimeError(
            f"cannot read the epoch of the study cell's checkpoint {meta} "
            f"({type(exc).__name__}: {exc}); it is left as it is: repair or delete "
            f"{last.parent.parent} to retrain the cell") from exc


def _train_cell(scfg: StudyConfig, toy: Path, splits: Path, au: str, eu: str,
                seed: int, version: str, train_seed: int) -> Path:
    from ..data.dataset import MultiRaterDataset
    from ..data.loader import BatchLoader
    from ..train.loop import Trainer

    # resumable matrix: a finished cell is skipped on re-runs. "Finished"
    # means the last checkpoint reached the final epoch; a run killed right
    # after an early epoch's "last" save is retrained
    done = (
        scfg.workdir / "saves" / _method_name(au, eu) / version
        / "checkpoints" / "last"
    )
    if done.exists():
        epoch = _finished_epoch(done)
        if epoch >= scfg.epochs - 1:
            return done
        import shutil

        print(f"[study] {_method_name(au, eu)}/{version}: stale checkpoint "
              f"(epoch {epoch} < {scfg.epochs - 1}) — retraining")
        shutil.rmtree(done.parent.parent)
    cfg = _load_run_config(scfg, toy, au, eu, seed, version=version,
                           train_seed=train_seed)
    trainer = Trainer(cfg, device=scfg.device)
    train_ds = MultiRaterDataset(splits, toy, split="train", return_all_raters=False)
    val_ds = MultiRaterDataset(splits, toy, split="val")
    trainer.fit(
        BatchLoader(train_ds, scfg.batch_size, shuffle=True, drop_last=True,
                    seed=train_seed),
        BatchLoader(val_ds, scfg.batch_size),
    )
    return trainer.workdir / "checkpoints" / "last"


def _train_one(
    scfg: StudyConfig, toy: Path, splits: Path, au: str, eu: str, seed: int
) -> Path | list[Path]:
    if eu == "ensemble":
        # deep ensemble: n_models independently-seeded members per study
        # seed, grouped at test time; member seeds are strided so no two
        # members share an init across study seeds
        return [
            _train_cell(scfg, toy, splits, au, eu, seed,
                        version=f"s{seed}_m{m}",
                        train_seed=1000 * (seed + 1) + m)
            for m in range(scfg.n_models)
        ]
    return _train_cell(scfg, toy, splits, au, eu, seed,
                       version=f"s{seed}", train_seed=seed)


def _inference_config(scfg: StudyConfig, au: str, eu: str, n_models: int, save_dir: Path,
                      version: str, **extra):
    from ..infer.runner import InferenceConfig

    return InferenceConfig(
        n_pred=scfg.n_pred, n_models=n_models, batch_size=scfg.batch_size,
        save_dir=str(save_dir), version=version, use_ema=True,
        tta=(au == "softmax"),  # TTA is the softmax AU sampler (README C1)
        skip_existing=True,
        # EU cells run one member at a time, as the JAX study bounds its
        # peak memory; the members of a dropout cell fold into the rows
        member_chunk=1 if eu != "none" else "auto",
        device=scfg.device, **extra)


def cell_inference_config(scfg: StudyConfig, au: str, eu: str, seed: int):
    """The inference job of one cell of the matrix."""
    return _inference_config(
        scfg, au, eu, 1 if eu == "none" else scfg.n_models, scfg.workdir / "results",
        f"s{seed}",
        diffusion_num_steps=scfg.diffusion_num_steps if au == "diffusion" else None,
        diffusion_sampler="ddim" if au == "diffusion" else None)


def _infer_one(
    scfg: StudyConfig, ckpt: Path | list[Path], au: str, eu: str, seed: int,
    splits_to_run: Sequence[str]
):
    from ..infer.runner import UncertaintyInference

    ckpts = ckpt if isinstance(ckpt, list) else [ckpt]
    inf = UncertaintyInference(ckpts, cell_inference_config(scfg, au, eu, seed))
    for split in splits_to_run:
        inf.run_split(split)
    return inf


def _run_al_arm(scfg: StudyConfig, toy: Path, splits: Path, exp_path: Path, seed: int) -> dict:
    """One AL second cycle: query the pool by uncertainty / random / worst,
    retrain, compare mean test Dice (``al_improvement`` both directions)."""
    from ..data.dataset import MultiRaterDataset
    from ..data.loader import BatchLoader
    from ..evaln.al_splits import generate_second_cycle_splits
    from ..evaln.tasks import al_improvement
    from ..infer.runner import UncertaintyInference
    from ..train.loop import Trainer

    au, eu = scfg.al_arm
    if eu == "ensemble":
        raise ValueError(
            "al_arm does not support eu='ensemble' (second-cycle retraining "
            "is single-member); pick none/dropout/swag for the AL arm"
        )
    pool_dir = exp_path / "unlabeled"
    # d1: first-cycle test Dice of this method/seed
    d1 = _mean_dice(exp_path / "id")

    dice2 = {}
    for strategy in ("uncertainty", "random", "worst"):
        out_splits = scfg.workdir / f"al_splits_{strategy}.pkl"
        generate_second_cycle_splits(
            splits, pool_dir / "aggregated_TU.json", out_splits,
            pool_split="unlabeled", strategy=strategy, seed=seed,
        )
        cfg = _load_run_config(scfg, toy, au, eu, seed)
        cfg = dataclasses.replace(
            cfg,
            exp_name=f"{_method_name(au, eu)}_al_{strategy}",
            data=dataclasses.replace(cfg.data, splits_path=str(out_splits)),
        )
        ckpt = (
            scfg.workdir / "saves" / cfg.exp_name / f"s{seed}"
            / "checkpoints" / "last"
        )
        if not ckpt.exists():  # resumable like the training matrix
            trainer = Trainer(cfg, device=scfg.device)
            train_ds = MultiRaterDataset(out_splits, toy, split="train",
                                         return_all_raters=False)
            trainer.fit(
                BatchLoader(train_ds, scfg.batch_size, shuffle=True,
                            drop_last=True, seed=seed),
                None,
            )
            ckpt = trainer.workdir / "checkpoints" / "last"
        icfg = _inference_config(scfg, au, eu, scfg.n_models, scfg.workdir / "results_al",
                                 f"s{seed}_{strategy}")
        inf = UncertaintyInference([ckpt], icfg)
        inf.run_split("id")
        dice2[strategy] = _mean_dice(inf.split_dir("id"))

    return {
        "dice_first_cycle": d1,
        "dice_second_cycle": dice2,
        # improvement of uncertainty- and worst-queried cycles over random:
        # the two directions of the reference's relative-improvement metric
        "al_improvement_uncertainty": al_improvement(d1, dice2["uncertainty"], dice2["random"]),
        "al_improvement_worst": al_improvement(d1, dice2["worst"], dice2["random"]),
    }


def _al_arm_runs(scfg: StudyConfig) -> bool:
    """The AL arm runs on its (AU, EU) cell: a matrix without that cell (an
    ``--au_types`` or ``--eu_methods`` that leaves it out) skips the arm,
    where the JAX study stops with ``StopIteration``."""
    return (scfg.al_arm is not None and bool(scfg.num_unlabeled)
            and scfg.al_arm[0] in scfg.au_types and scfg.al_arm[1] in scfg.eu_methods)


def _mean_dice(split_dir: Path) -> float:
    metrics = json.loads((split_dir / "metrics.json").read_text())
    return float(np.mean([rec["metrics"]["dice"] for rec in metrics.values()]))


def study_environment(device: str) -> dict:
    """The torch device the study ran on: on the card its name, the device
    count and the CUDA version."""
    import platform

    import torch

    if torch.device(device).type == "cuda":
        return {"device": "cuda", "device_name": torch.cuda.get_device_name(),
                "n_devices": torch.cuda.device_count(), "cuda": torch.version.cuda,
                "torch": torch.__version__}
    return {"device": "cpu", "device_name": platform.processor() or platform.machine(),
            "n_devices": 1, "cuda": None, "torch": torch.__version__}


def _check_workdir(work: Path, scfg: StudyConfig) -> None:
    """Fail FAST on a workdir built with different cell-shaping parameters:
    cached checkpoints would silently mix epochs/data otherwise."""
    shape_fields = (
        "epochs", "image_size", "ambiguity", "num_train", "num_val",
        "num_test", "num_ood", "num_unlabeled", "batch_size",
        "model_channels", "n_pred", "n_models", "diffusion_num_steps",
    )
    shape = {k: getattr(scfg, k) for k in shape_fields}
    meta_path = work / "study_meta.json"
    if meta_path.exists():
        prev = json.loads(meta_path.read_text())
        if prev != shape:
            diff = {k: (prev.get(k), shape[k]) for k in shape if prev.get(k) != shape[k]}
            raise ValueError(
                f"workdir {work} holds cells built with different study "
                f"parameters {diff} (old, new); cached checkpoints would mix "
                f"— use a fresh workdir or matching parameters"
            )
    else:
        meta_path.write_text(json.dumps(shape, indent=2))


def run_values_study(scfg: StudyConfig) -> dict:
    import torch

    from ..data.dataset import MultiRaterDataset
    from ..data.toy import generate_toy_dataset
    from ..evaln.experiments import EvalMatrix, expand_versions
    from ..evaln.visualization import (
        au_eu_scatter, collect_results, rank_table, task_table, to_latex)

    if torch.device(scfg.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the study runs on cuda but torch.cuda.is_available() is False; "
                           "pass device='cpu' (--device cpu) to run it on the CPU")
    t0 = time.time()
    work = Path(scfg.workdir)
    work.mkdir(parents=True, exist_ok=True)
    report_dir = work / "report"
    report_dir.mkdir(exist_ok=True)
    _check_workdir(work, scfg)

    # 1. controlled environment ------------------------------------------------
    toy = generate_toy_dataset(
        work / "toy", num_train=scfg.num_train, num_val=scfg.num_val,
        num_test=scfg.num_test, num_ood=scfg.num_ood, size=scfg.image_size,
        ambiguity=scfg.ambiguity, seed=0, ood_shifts=scfg.ood_shifts,
        num_unlabeled=scfg.num_unlabeled,
    )
    splits = toy / "splits" / "default" / "firstCycle" / "splits.pkl"

    # 2+3. training & inference matrix -----------------------------------------
    cells = [
        (au, eu, seed)
        for au in scfg.au_types for eu in scfg.eu_methods for seed in scfg.seeds
    ]
    eval_splits = ["id", "val", *scfg.ood_shifts]
    epochs_seen = set()
    infer_handles = {}
    walls: dict = {"cells": {}}
    for au, eu, seed in cells:
        label = f"{_method_name(au, eu)}_s{seed}"
        t_cell = time.time()
        ckpt = _train_one(scfg, toy, splits, au, eu, seed)
        t_trained = time.time()
        splits_to_run = list(eval_splits)
        if _al_arm_runs(scfg) and scfg.al_arm == (au, eu) and seed == scfg.seeds[0]:
            splits_to_run.append("unlabeled")
        inf = _infer_one(scfg, ckpt, au, eu, seed, splits_to_run)
        epochs_seen.add(inf.epoch)
        infer_handles[label] = inf
        walls["cells"][label] = {"train_s": t_trained - t_cell,
                                 "infer_s": time.time() - t_trained}
        print(f"[study] {label}: trained {scfg.epochs} epochs, inferenced {splits_to_run}")
    assert len(epochs_seen) == 1, f"non-uniform epochs {epochs_seen}"
    epoch = epochs_seen.pop()

    # 4. evaluation matrix ------------------------------------------------------
    versions = expand_versions(
        work / "results",
        [{
            "iter_params": {
                "pred_model": [_method_name(au, eu) for au in scfg.au_types
                               for eu in scfg.eu_methods],
                "seed": list(scfg.seeds),
            },
            "exp_name": "{pred_model}",
            # inference runs with use_ema=True -> e{epoch}_ema result dirs
            "naming_scheme_version": "s{seed}/e{epoch}_ema",
            "n_pred": scfg.n_pred,
            "epoch": epoch,
        }],
    )

    def dataset_factory(version, split):
        try:
            return MultiRaterDataset(splits, toy, split=split)
        except Exception:
            return None

    def make_matrix(vs):
        return EvalMatrix(vs, dataset_factory=dataset_factory,
                          paired_splits=[("id", s) for s in scfg.ood_shifts], ignore_value=-1)

    # each version's tasks read and write only its own tree: one matrix per
    # version runs what the whole matrix runs, and times each cell
    for v in versions:
        t_eval = time.time()
        make_matrix([v]).run(TASKS)
        walls["cells"][f"{v.pred_model}_s{v.params['seed']}"]["evaluate_s"] = (
            time.time() - t_eval)
    matrix = make_matrix(versions)

    # 5. active-learning arm ----------------------------------------------------
    al_results = None
    t_al = time.time()
    if _al_arm_runs(scfg):
        arm_label = _method_name(*scfg.al_arm)
        arm_version = next(
            v for v in versions
            if v.pred_model == arm_label and v.params["seed"] == scfg.seeds[0]
        )
        al_results = _run_al_arm(scfg, toy, splits, arm_version.exp_path, scfg.seeds[0])
    walls["al_s"] = time.time() - t_al

    # 6. report ------------------------------------------------------------------
    t_report = time.time()
    by_label_split = {
        f"{v.pred_model}_s{v.params['seed']}": v.exp_path / "id" for v in versions
    }
    by_label_exp = {
        f"{v.pred_model}_s{v.params['seed']}": v.exp_path for v in versions
    }
    rows = (collect_results(by_label_split)
            + collect_results(by_label_exp, include_segmentation=False))
    table = task_table(rows, group_seeds=True)
    table.to_csv(report_dir / "ds_task_table.csv")
    (report_dir / "ds_task_table.tex").write_text(to_latex(table))
    # rank-aggregated view: per-row method ranks + mean rank across the
    # whole task matrix (the paper's "which method wins overall" summary)
    rank_table(table).to_csv(report_dir / "ds_task_ranks.csv")
    scatter_path = None
    try:
        scatter_path = au_eu_scatter(
            rows, task="ood_detection", metric="auroc",
            out_path=report_dir / "au_eu_scatter.png",
        )
    except ValueError:
        pass  # matrix too small to carry both AU and EU rows

    figures = _report_figures(
        report_dir, scfg, rows, versions, infer_handles, al_results, splits, toy,
    )
    checks = _direction_checks(rows, scfg, al_results)
    diagnosis = None
    if "ood_noise" in scfg.ood_shifts:
        try:
            diagnosis = _eu_noise_diagnosis(versions, scfg)
        except Exception as e:  # pragma: no cover - diagnostic only
            print(f"[study] eu_noise diagnosis skipped: {type(e).__name__}: {e}")
    environment = study_environment(scfg.device)
    walls["report_s"] = time.time() - t_report
    summary = {
        "matrix": {
            "au_types": list(scfg.au_types),
            "eu_methods": list(scfg.eu_methods),
            "seeds": list(scfg.seeds),
            "epochs": scfg.epochs,
            "n_pred": scfg.n_pred,
            "n_models": scfg.n_models,
            "image_size": scfg.image_size,
            "ambiguity": scfg.ambiguity,
            "num_train": scfg.num_train,
            "num_test": scfg.num_test,
            "versions": len(versions),
        },
        "preflight": matrix.classify(TASKS),
        "checks": checks,
        "eu_noise_diagnosis": diagnosis,
        "al": al_results,
        "environment": environment,
        "wall_seconds": round(time.time() - t0, 1),
        "walls": walls,
        "artifacts": {
            "table_csv": str(report_dir / "ds_task_table.csv"),
            "table_tex": str(report_dir / "ds_task_table.tex"),
            "rank_csv": str(report_dir / "ds_task_ranks.csv"),
            "scatter": str(scatter_path) if scatter_path else None,
            "figures": figures,
        },
    }
    (report_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    _write_report_md(report_dir, scfg, rows, checks, al_results, figures,
                     diagnosis=diagnosis, environment=environment,
                     wall_seconds=summary["wall_seconds"])
    return summary


def _report_figures(
    report_dir: Path,
    scfg: StudyConfig,
    rows,
    versions,
    infer_handles: dict,
    al_results,
    splits: Path,
    toy: Path,
) -> dict:
    """The diagnostic figure set of the study report: risk–coverage curves, a
    reliability diagram, per-shift OoD AUROC bars, the AL second-cycle
    panel, the task overview (charts, as JSON) and a qualitative AU/EU/TU
    triptych across AU types (a PNG). Figures are best-effort: a failure is
    reported but never fails the study."""
    from ..data.dataset import MultiRaterDataset
    from ..evaln.dataloader import ResultsReader
    from ..evaln.visualization import (
        al_improvement_plot,
        barplot,
        metric_matrix_grid,
        reliability_diagram,
        risk_coverage_plot,
        uncertainty_triptych_panel,
    )

    figures: dict = {}
    seed0 = scfg.seeds[0]

    def _try(name, fn):
        try:
            figures[name] = str(fn())
        except Exception as e:  # pragma: no cover - diagnostic only
            print(f"[study] report figure {name} skipped: {type(e).__name__}: {e}")

    # risk–coverage on the id split: TU heatmap, image_level aggregation,
    # seed-0 version of every method (risk = 1 - Dice, fd-shifts convention)
    def _risk_coverage():
        series = {}
        for v in versions:
            if v.params["seed"] != seed0:
                continue
            reader = ResultsReader(v.exp_path / "id")
            unc = "TU" if "TU" in reader.unc_types else reader.unc_types[0]
            metrics, agg = reader.metrics(), reader.aggregated(unc)
            risks, confids = [], []
            for image_id in reader.image_ids:
                risks.append(1.0 - metrics[image_id]["metrics"]["dice"])
                key = next(k for k in agg if k.startswith(image_id))
                confids.append(-agg[key]["image_level"]["max_score"])
            series[v.pred_model] = (risks, confids)
        if not series:
            raise ValueError("no seed-0 versions with id results")
        return risk_coverage_plot(
            series, report_dir / "risk_coverage_id.png",
            title="failure detection (id split, TU image_level)",
        )

    _try("risk_coverage", _risk_coverage)

    # reliability diagram: Platt-scaled pixel confidences of the AL-arm
    # method on the id split (mirrors evaln.tasks.calibration)
    def _reliability():
        label = _method_name(*scfg.al_arm) if scfg.al_arm else versions[0].pred_model
        v = next(
            v for v in versions
            if v.pred_model == label and v.params["seed"] == seed0
        )
        ds = MultiRaterDataset(splits, toy, split="id")
        reader = ResultsReader(v.exp_path / "id", dataset=ds)
        params = json.loads((v.exp_path / "platt_scale_params.json").read_text())
        unc = "TU" if "TU" in reader.unc_types else reader.unc_types[0]
        a, b = params[unc]["a"], params[unc]["b"]
        correct_all, confid_all = [], []
        for image_id in reader.image_ids:
            refs = reader.get_reference_segs(image_id)
            pred = reader.get_mean_pred_seg(image_id)
            unc_map = reader.get_unc_map(image_id, unc)
            if pred.shape != unc_map.shape:
                unc_map = np.swapaxes(unc_map, 0, 1)
            mask = refs != -1  # matrix runs with ignore_value=-1
            correct = (refs == pred[None])[mask].astype(np.float64)
            u = np.broadcast_to(unc_map[None], refs.shape)[mask]
            correct_all.append(correct.ravel())
            confid_all.append(1.0 / (1.0 + np.exp((-u.ravel()) * a + b)))
        return reliability_diagram(
            np.concatenate(correct_all), np.concatenate(confid_all),
            report_dir / "reliability_id.png",
            title=f"{label} (id split, Platt-scaled {unc})",
        )

    _try("reliability", _reliability)

    # per-shift OoD AUROC bars (unc_type x method, image_level)
    for shift in scfg.ood_shifts:
        def _ood_bar(shift=shift):
            sel = [r for r in rows if r["dataset"] == f"id&{shift}"
                   and r["aggregation"] == "image_level"]
            return barplot(
                sel, task="ood_detection", metric="auroc",
                out_path=report_dir / f"ood_auroc_{shift}.png",
            )

        _try(f"ood_auroc_{shift}", _ood_bar)

    # AL second-cycle panel
    if al_results is not None and scfg.al_arm is not None:
        def _al_plot():
            label = _method_name(*scfg.al_arm)
            cycles = {label: {"first": al_results["dice_first_cycle"],
                              **al_results["dice_second_cycle"]}}
            return al_improvement_plot(cycles, report_dir / "al_improvement.png")

        _try("al_improvement", _al_plot)

    # qualitative AU/EU/TU triptych: the no-EU version of each AU type on
    # shared id images (raw prediction stacks re-sampled from checkpoints)
    def _triptych():
        raws = {}
        for au in scfg.au_types:
            handle = infer_handles.get(f"{_method_name(au, scfg.eu_methods[0])}_s{seed0}")
            if handle is not None:
                raws[au] = handle.collect_raw_predictions("id", num_images=2, seed=0)
        if len(raws) < 2:
            raise ValueError("need >=2 AU types with inference handles")
        return uncertainty_triptych_panel(
            raws, report_dir / "uncertainty_triptych.png", n_images=2,
        )

    _try("triptych", _triptych)

    # one-figure task overview: (unc_type x aggregation) heatmap per
    # downstream-task metric, mean over every version in the matrix
    def _task_overview():
        return metric_matrix_grid(
            rows,
            cells=[("ood_detection", "auroc"), ("failure_detection", "aurc"),
                   ("calibration", "ace"), ("ambiguity_modeling", "ncc")],
            out_path=report_dir / "task_matrix_overview.png",
            ncols=2,
        )

    _try("task_overview", _task_overview)
    return figures


def _per_seed(rows, seeds) -> dict:
    """``{seed: mean value}`` for the rows of one method/unc_type cell."""
    from ..evaln.visualization import nan_mean

    out = {}
    for seed in seeds:
        r = [row for row in rows if row["version"].endswith(f"_s{seed}")]
        if len(r):
            out[int(seed)] = nan_mean([row["value"] for row in r])
    return out


def _spread(values) -> float:
    """Inter-seed spread = max - min of the per-seed values (0 for <2 seeds)."""
    vals = [v for v in values if np.isfinite(v)]
    return float(max(vals) - min(vals)) if len(vals) >= 2 else 0.0


def _direction_checks(rows, scfg: StudyConfig, al_results) -> dict:
    """Direction-of-effect checks over the seed-grouped results.

    Every check quantity is reported WITH its per-seed values and inter-seed
    spread (max - min over seeds), and each comparison carries a
    ``decided_by_margin`` verdict: the effect only counts as decided when the
    mean margin exceeds the larger of the two series' seed spreads.
    """
    from ..evaln.visualization import nan_mean

    checks: dict = {}

    # (a) OoD detection, PER SHIFT: EU-method mutual-information heatmaps vs
    # the softmax-entropy (TU) baseline of the no-EU softmax method,
    # image_level. Input noise raises predictive entropy directly, so TU
    # saturates and EU adds nothing; blur makes the model MORE confident (TU
    # anti-detects) and only member disagreement (EU) sees the shift — the
    # direction claim is therefore per-shift
    ood = [r for r in rows if r["task"] == "ood_detection" and r["metric"] == "auroc"
           and r["aggregation"] == "image_level"]
    per_shift: dict = {}
    beats_somewhere = False
    beats_somewhere_by_margin = False
    for shift in scfg.ood_shifts:
        sel = [r for r in ood if r["dataset"] == f"id&{shift}"]
        baseline_rows = [r for r in sel if r["unc_type"] == "TU"
                         and r["version"].startswith("softmax_none_s")]
        base_per_seed = _per_seed(baseline_rows, scfg.seeds)
        baseline = (
            float(np.mean(list(base_per_seed.values())))
            if base_per_seed else float("nan")
        )
        eu_scores, eu_seeds = {}, {}
        for eu in scfg.eu_methods:
            if eu == "none":
                continue
            eu_rows = [r for r in sel if r["unc_type"] == "EU" and f"_{eu}_s" in r["version"]]
            if len(eu_rows):
                eu_scores[eu] = nan_mean([r["value"] for r in eu_rows])
                eu_seeds[eu] = _per_seed(eu_rows, scfg.seeds)
        best_eu = max(eu_scores.values()) if eu_scores else float("nan")
        best_name = max(eu_scores, key=eu_scores.get) if eu_scores else None
        beats = bool(np.isfinite(best_eu) and np.isfinite(baseline) and best_eu > baseline)
        margin = float(best_eu - baseline) if beats or (
            np.isfinite(best_eu) and np.isfinite(baseline)) else float("nan")
        spread = max(
            _spread(base_per_seed.values()),
            _spread(eu_seeds.get(best_name, {}).values()) if best_name else 0.0,
        )
        decided = bool(np.isfinite(margin) and abs(margin) > spread)
        beats_somewhere = beats_somewhere or beats
        beats_somewhere_by_margin = beats_somewhere_by_margin or (beats and decided)
        per_shift[shift] = {
            "softmax_entropy_baseline": baseline,
            "baseline_per_seed": base_per_seed,
            "eu_methods": eu_scores,
            "eu_methods_per_seed": eu_seeds,
            "best_eu": best_eu,
            "best_eu_method": best_name,
            "margin_best_eu_minus_baseline": margin,
            "seed_spread": spread,
            "eu_beats_entropy_baseline": beats,
            "decided_by_margin": decided,
        }
    checks["ood_auroc"] = {
        "per_shift": per_shift,
        "eu_beats_entropy_on_some_shift": beats_somewhere,
        "eu_beats_entropy_on_some_shift_by_margin": beats_somewhere_by_margin,
        "margin_convention": "decided when |mean margin| > max of the two "
                             "series' inter-seed spreads (max-min over seeds)",
        "eu_pooling": "each EU method's score pools (means) its cells across "
                      "all AU types; per-(AU x EU)-pair values are in "
                      "ds_task_table.csv — e.g. softmax_dropout alone can "
                      "score far above the pooled dropout mean",
    }

    # (b) ambiguity: AU heatmaps correlate with rater-variance GT maps;
    # positivity is likewise decided per AU type against its seed spread
    amb = [r for r in rows if r["task"] == "ambiguity_modeling" and r["metric"] == "ncc"
           and r["unc_type"] == "AU"]
    ncc_by_method, ncc_seeds, ncc_margin = {}, {}, {}
    for au in scfg.au_types:
        au_rows = [r for r in amb if r["version"].startswith(f"{au}_")]
        if len(au_rows):
            ncc_by_method[au] = nan_mean([r["value"] for r in au_rows])
            ncc_seeds[au] = _per_seed(au_rows, scfg.seeds)
            ncc_margin[au] = bool(
                ncc_by_method[au] > _spread(ncc_seeds[au].values())
            )
    checks["ambiguity_ncc"] = {
        "mean_au_ncc_by_au_type": ncc_by_method,
        "per_seed_ncc_by_au_type": ncc_seeds,
        "positive_by_margin_by_au_type": ncc_margin,
        "au_positively_correlated": bool(
            ncc_by_method and np.mean(list(ncc_by_method.values())) > 0
        ),
        "all_au_types_positive_by_margin": bool(
            ncc_margin and all(ncc_margin.values())
        ),
    }

    # (c) active learning: both directions computed
    if al_results is not None:
        checks["al_improvement"] = {
            "uncertainty_vs_random": al_results["al_improvement_uncertainty"],
            "worst_vs_random": al_results["al_improvement_worst"],
            "computed_both_directions": bool(
                np.isfinite(al_results["al_improvement_uncertainty"])
                and np.isfinite(al_results["al_improvement_worst"])
            ),
        }
    return checks


def _eu_noise_diagnosis(versions, scfg: StudyConfig, shift: str = "ood_noise") -> dict:
    """Root-cause instrumentation for EU's behaviour on the noise shift.

    Measures, on one EU version (dropout, first seed), the quantities the
    AUROC ranks (image-level aggregated EU/TU scores) plus pixel-level
    heatmap means on id vs shift images, and derives the mechanism from the
    numbers: when members agree on the noise-dominated prediction, MI = TU −
    AU collapses on OoD while TU saturates, and EU anti-detects. The AUROC is
    the rank form of ``evaln/tasks.py`` (scikit-learn's ``roc_auc_score``).
    """
    from ..evaln.dataloader import ResultsReader
    from ..evaln.tasks import auroc

    label = None
    for eu in ("dropout", "ensemble", "swag"):
        cand = f"softmax_{eu}"
        if any(v.pred_model == cand for v in versions):
            label = cand
            break
    if label is None:
        raise ValueError("no EU version to diagnose")
    v = next(v for v in versions
             if v.pred_model == label and v.params["seed"] == scfg.seeds[0])

    out: dict = {"version": f"{label}_s{scfg.seeds[0]}", "shift": shift}
    scores: dict = {}
    for split in ("id", shift):
        reader = ResultsReader(v.exp_path / split)
        rec: dict = {}
        for unc in ("EU", "TU"):
            if unc not in reader.unc_types:
                continue
            agg = reader.aggregated(unc)
            img_scores = [r["image_level"]["max_score"] for r in agg.values()
                          if "image_level" in r]
            pix_means = [float(np.mean(reader.get_unc_map(i, unc)))
                         for i in reader.image_ids]
            rec[unc] = {
                "image_level_mean": float(np.mean(img_scores)),
                "image_level_per_image": [round(float(s), 5) for s in img_scores],
                "pixel_mean": float(np.mean(pix_means)),
            }
            scores.setdefault(unc, {})[split] = img_scores
        out[split] = rec

    for unc, by_split in scores.items():
        if "id" in by_split and shift in by_split:
            id_s, ood_s = by_split["id"], by_split[shift]
            out[f"auroc_{unc}"] = auroc([0] * len(id_s) + [1] * len(ood_s),
                                        list(id_s) + list(ood_s))

    eu_id = out.get("id", {}).get("EU", {}).get("image_level_mean")
    eu_ood = out.get(shift, {}).get("EU", {}).get("image_level_mean")
    tu_id = out.get("id", {}).get("TU", {}).get("image_level_mean")
    tu_ood = out.get(shift, {}).get("TU", {}).get("image_level_mean")
    if None not in (eu_id, eu_ood, tu_id, tu_ood):
        if eu_ood < eu_id and tu_ood > tu_id:
            out["root_cause"] = (
                f"anti-detection mechanism CONFIRMED on {out['version']}: "
                f"mean image-level EU drops on {shift} ({eu_ood:.4g}) vs id "
                f"({eu_id:.4g}) while TU rises ({tu_ood:.4g} vs {tu_id:.4g}) "
                "— members agree on the noise-dominated prediction, so "
                "per-member entropies match the mean-probability entropy and "
                "MI = TU - AU collapses on OoD; EU ranks OoD below id and "
                f"scores AUROC {out.get('auroc_EU', float('nan')):.3f} < 0.5 "
                "by mechanism, not by noise. The entropy baseline saturates "
                f"instead (TU AUROC {out.get('auroc_TU', float('nan')):.3f}) "
                "— exactly why ValUES scores OoD per shift: noise is a "
                "TU-shift, blur is the EU-shift."
            )
        else:
            out["root_cause"] = (
                f"anti-detection does NOT reproduce at this training scale on "
                f"{out['version']}: EU {shift} mean {eu_ood:.4g} vs id "
                f"{eu_id:.4g} (AUROC {out.get('auroc_EU', float('nan')):.3f}); "
                "the round-4 below-chance number was an artifact of the "
                "undertrained 32px matrix."
            )
    return out


def _interpretation_lines(checks: dict, al_results) -> list[str]:
    """Interpretation derived from THIS run's computed checks — the static
    text explains the designed mechanisms; every conclusion about outcomes
    is phrased from the numbers in ``checks``/``al_results``."""
    lines: list[str] = []

    ood = checks.get("ood_auroc", {})
    per_shift = ood.get("per_shift", {})
    beating = sorted(s for s, rec in per_shift.items()
                     if rec.get("eu_beats_entropy_baseline"))
    by_margin = sorted(s for s, rec in per_shift.items()
                       if rec.get("eu_beats_entropy_baseline")
                       and rec.get("decided_by_margin"))
    margin_txt = ""
    if any("margin_best_eu_minus_baseline" in rec for rec in per_shift.values()):
        parts = []
        for s in sorted(per_shift):
            rec = per_shift[s]
            m = rec.get("margin_best_eu_minus_baseline")
            sp = rec.get("seed_spread")
            if m is not None and sp is not None and np.isfinite(m):
                parts.append(
                    f"{s}: margin {m:+.3f} vs seed spread {sp:.3f} "
                    f"({'decided' if rec.get('decided_by_margin') else 'within spread'})"
                )
        if parts:
            margin_txt = " Margins: " + "; ".join(parts) + "."
    lines.append(
        "- **OoD detection is shift-dependent by design**: input noise raises "
        "predictive entropy directly (the softmax-entropy TU baseline "
        "saturates), while blur tends to make the model *more* confident so "
        "only member disagreement (EU) can see it. In this run the best EU "
        f"method beats the entropy baseline on "
        f"{', '.join(beating) if beating else 'NO shift (check failed)'} "
        f"out of {sorted(per_shift)}"
        + (f" — decided by a margin exceeding the inter-seed spread on "
           f"{', '.join(by_margin)}" if by_margin else "")
        + " — "
        + ("matching the ValUES conclusion that EU methods matter for "
           "silent-failure shifts rather than dominating uniformly."
           if beating else "an unexpected outcome worth investigating.")
        + margin_txt
    )

    amb = checks.get("ambiguity_ncc", {})
    by_au = amb.get("mean_au_ncc_by_au_type", {})
    if by_au:
        mean_ncc = float(np.mean(list(by_au.values())))
        by_margin_au = amb.get("positive_by_margin_by_au_type", {})
        margin_au_txt = ""
        if by_margin_au:
            solid = sorted(k for k, ok in by_margin_au.items() if ok)
            margin_au_txt = (
                f" Positive beyond seed spread: "
                f"{', '.join(solid) if solid else 'none'} "
                f"of {sorted(by_margin_au)}."
            )
        lines.append(
            f"- **Ambiguity (NCC)**: mean AU-vs-rater-variance NCC over AU "
            f"types is {mean_ncc:+.3f} "
            f"({'positive' if mean_ncc > 0 else 'NEGATIVE — check failed'}); "
            f"per method: "
            + ", ".join(f"{k} {v:+.3f}" for k, v in sorted(by_au.items())) + "."
            + margin_au_txt
        )

    if al_results is not None:
        ai_u = al_results["al_improvement_uncertainty"]
        ai_w = al_results["al_improvement_worst"]
        flat = abs(ai_u) < 0.01 and abs(ai_w) < 0.01
        lines.append(
            f"- **Active learning**: uncertainty-vs-random improvement "
            f"{ai_u:+.4f}, worst-vs-random {ai_w:+.4f} — "
            + ("flat within noise on this toy, consistent with the reference "
               "study's finding that uncertainty-based AL gains are not "
               "reliable; the arm's value is that both improvement "
               "directions are computed end to end."
               if flat else "a non-flat result; see dice_second_cycle for "
               "the per-strategy numbers.")
        )
    return lines


_FIGURE_CAPTIONS = {
    "risk_coverage": "risk–coverage curves per method (failure detection)",
    "reliability": "reliability diagram, Platt-scaled pixel confidences",
    "al_improvement": "active-learning second-cycle panel",
    "triptych": "qualitative AU/EU/TU heatmaps across AU types",
}


def _environment_line(environment: dict, wall_seconds: float | None) -> str:
    cuda = f", CUDA {environment['cuda']}" if environment.get("cuda") else ""
    return (
        f"Ran on torch device `{environment['device']}` "
        f"({environment['n_devices']} device(s): {environment['device_name']}{cuda})"
        + (f", wall-clock {wall_seconds:.0f}s this invocation"
           " (resumed invocations exclude cached cells)."
           if wall_seconds is not None else ".")
    )


def _write_report_md(
    report_dir: Path, scfg: StudyConfig, rows, checks, al_results,
    figures: dict | None = None, diagnosis: dict | None = None,
    environment: dict | None = None, wall_seconds: float | None = None,
) -> None:
    """``REPORT.md``. A chart's entry links its series (``.json``); an image
    panel's is an image."""
    figures = figures or {}
    env_line = _environment_line(environment, wall_seconds) if environment else ""
    lines = [
        "# ValUES study on the controlled toy environment",
        "",
        f"Matrix: AU {list(scfg.au_types)} x EU {list(scfg.eu_methods)} x "
        f"seeds {list(scfg.seeds)} ({scfg.epochs} epochs, n_pred={scfg.n_pred}, "
        f"n_models={scfg.n_models}, {scfg.image_size}px toy, "
        f"ambiguity={scfg.ambiguity}, {scfg.num_train} train / "
        f"{scfg.num_test} test images).",
        "",
        *([env_line, ""] if env_line else []),
        "Artifacts: `ds_task_table.csv` / `.tex` (seed-grouped downstream-task "
        "table), `ds_task_ranks.csv` (per-row method ranks + mean rank), "
        "`au_eu_scatter.json` (AU-vs-EU OoD AUROC), `summary.json`.",
        "",
        "## Direction-of-effect checks",
        "",
        "```json",
        json.dumps(checks, indent=2),
        "```",
        "",
        "## Interpretation",
        "",
    ] + _interpretation_lines(checks, al_results)
    if diagnosis is not None and "root_cause" in diagnosis:
        lines += [
            "",
            "## EU on the noise shift — root cause",
            "",
            diagnosis["root_cause"],
            "",
            f"Measured on `{diagnosis['version']}`: image-level EU "
            f"id {diagnosis['id']['EU']['image_level_mean']:.4g} vs "
            f"{diagnosis['shift']} "
            f"{diagnosis[diagnosis['shift']]['EU']['image_level_mean']:.4g}; "
            f"TU id {diagnosis['id']['TU']['image_level_mean']:.4g} vs "
            f"{diagnosis['shift']} "
            f"{diagnosis[diagnosis['shift']]['TU']['image_level_mean']:.4g}; "
            f"recomputed rank AUROC: EU {diagnosis.get('auroc_EU', float('nan')):.3f}, "
            f"TU {diagnosis.get('auroc_TU', float('nan')):.3f} "
            "(full per-image scores in `summary.json` → `eu_noise_diagnosis`).",
        ]
    if figures:
        lines += ["", "## Figures", ""]
        for name, path in sorted(figures.items()):
            caption = _FIGURE_CAPTIONS.get(
                name,
                "per-shift OoD AUROC barplot" if name.startswith("ood_auroc")
                else name,
            )
            image = Path(path).suffix == ".png"
            lines.append(f"{'!' if image else ''}[{caption}]({Path(path).name})")
            lines.append("")
    if al_results is not None:
        lines += ["", "## Active-learning arm", "", "```json",
                  json.dumps(al_results, indent=2), "```"]
    (report_dir / "REPORT.md").write_text("\n".join(lines) + "\n")


def study_config(argv: Sequence[str] | None = None) -> StudyConfig:
    """The study the command line asks for (the JAX flags, ``--device`` in
    place of ``--cpu``)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--image_size", type=int, default=32)
    ap.add_argument("--ambiguity", type=float, default=0.15)
    ap.add_argument("--num_train", type=int, default=24)
    ap.add_argument("--num_test", type=int, default=16)
    ap.add_argument("--num_val", type=int, default=8)
    ap.add_argument("--num_unlabeled", type=int, default=12)
    ap.add_argument("--n_pred", type=int, default=4)
    ap.add_argument("--n_models", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--model_channels", type=int, default=8)
    ap.add_argument("--val_every", type=int, default=1)
    ap.add_argument("--au_types", nargs="+", default=None,
                    help="AU axis override (softmax ssn diffusion prob_unet)")
    ap.add_argument("--eu_methods", nargs="+", default=None,
                    help="EU axis override (none dropout swag ensemble)")
    ap.add_argument("--loggers", nargs="+", default=None,
                    help="the trainer's metric loggers (default: the config's)")
    ap.add_argument("--quick", action="store_true",
                    help="2 AU x 2 EU miniature (smoke)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="torch device of training and inference (default cuda)")
    args = ap.parse_args(argv)
    scfg = StudyConfig(workdir=Path(args.workdir), epochs=args.epochs,
                       seeds=tuple(args.seeds), image_size=args.image_size,
                       ambiguity=args.ambiguity, num_train=args.num_train,
                       num_test=args.num_test, num_ood=args.num_test,
                       num_val=args.num_val, num_unlabeled=args.num_unlabeled,
                       n_pred=args.n_pred, n_models=args.n_models,
                       batch_size=args.batch_size,
                       model_channels=args.model_channels,
                       val_every=args.val_every, device=args.device,
                       loggers=tuple(args.loggers) if args.loggers else None)
    if args.au_types:
        scfg = dataclasses.replace(scfg, au_types=tuple(args.au_types))
    if args.eu_methods:
        scfg = dataclasses.replace(scfg, eu_methods=tuple(args.eu_methods))
    if args.quick:
        scfg = dataclasses.replace(
            scfg, au_types=("softmax", "ssn"), eu_methods=("none", "dropout"),
            epochs=min(args.epochs, 3), num_train=16, num_test=8, num_ood=8,
            num_unlabeled=8, ood_shifts=("ood_noise",),
        )
    return scfg


def main(argv: Sequence[str] | None = None) -> dict:
    scfg = study_config(argv)
    summary = run_values_study(scfg)
    print(json.dumps(summary["checks"], indent=2))
    print(f"study complete in {summary['wall_seconds']}s -> {scfg.workdir}/report")
    return summary


if __name__ == "__main__":
    main()
