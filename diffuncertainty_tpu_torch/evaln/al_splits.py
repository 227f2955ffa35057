"""Active-learning second-cycle split generation (port of
``diffuncertainty_tpu/evaln/al_splits.py``).

Reference (``evaluation/split_file_generation/split_files_second_cycle.py:13-156``
and ``_random.py``): query the top-50% most-uncertain unlabeled samples by an
aggregated score and move them from the unlabeled pool into train for cycle
two; random / best / worst control baselines. The random strategy draws from
numpy's generator, so its queries equal the JAX package's for a seed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..data.dataset import load_splits, save_splits


def sorted_by_uncertainty(aggregated: dict, aggregation: str) -> list[str]:
    """Sample keys sorted most-uncertain first."""
    scores = {k: v[aggregation]["max_score"] for k, v in aggregated.items()}
    return sorted(scores, key=scores.get, reverse=True)


def samples_to_query(sorted_samples: list[str], fraction: float = 0.5) -> list[str]:
    n = int(np.ceil(len(sorted_samples) * fraction))
    return sorted_samples[:n]


def generate_second_cycle_splits(
    first_cycle_splits_path: str | Path,
    aggregated_unc_file: str | Path,
    out_splits_path: str | Path,
    *,
    aggregation: str = "image_level",
    pool_split: str = "unlabeled",
    fraction: float = 0.5,
    strategy: str = "uncertainty",  # uncertainty | random | best | worst
    seed: int = 0,
    fold: int = 0,
    unc_ending: str = ".tif",
) -> list[str]:
    """Move the queried pool samples into train; returns the queried ids."""
    folds = load_splits(first_cycle_splits_path)
    fold_dict = dict(folds[fold])
    pool = list(np.asarray(fold_dict[pool_split]).tolist())

    if strategy in ("uncertainty", "best", "worst"):
        aggregated = json.loads(Path(aggregated_unc_file).read_text())
        ranked = sorted_by_uncertainty(aggregated, aggregation)
        # keys are "{image_id}{ending}" -> map back to pool paths by stem
        by_stem = {Path(p).stem: p for p in pool}
        ranked_paths = [by_stem[Path(k).stem.replace(unc_ending, "")]
                        for k in ranked if Path(k).stem.replace(unc_ending, "") in by_stem]
        if strategy == "worst":  # least uncertain first (control)
            ranked_paths = ranked_paths[::-1]
        queried = samples_to_query(ranked_paths, fraction)
    elif strategy == "random":
        rng = np.random.default_rng(seed)
        queried = list(rng.choice(pool, int(np.ceil(len(pool) * fraction)), replace=False))
    else:
        raise ValueError(strategy)

    queried_set = set(queried)
    fold_dict["train"] = list(fold_dict["train"]) + queried
    fold_dict[pool_split] = [p for p in pool if p not in queried_set]
    new_folds = list(folds)
    new_folds[fold] = fold_dict
    save_splits(new_folds, out_splits_path)
    return queried
