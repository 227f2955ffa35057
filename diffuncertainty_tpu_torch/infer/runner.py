"""The uncertainty-inference job (port of ``diffuncertainty_tpu/infer/runner.py``).

From one or more checkpoints (``core/checkpoint.py``) and a split on disk to
the results tree (``infer/results.py``):

- each checkpoint's weights (``params``, or ``ema_params`` with ``use_ema``
  or in an EMA-only snapshot) become the port's state dict;
- EU members: MC-dropout members fold into the rows of one forward; SWAG and
  SWAG-diag members are drawn by ``models/swag.py::sample_members`` from a
  generator seeded ``seed``; several checkpoints of one architecture and a
  trivial EU method stack into one member stack (a deep ensemble); a mix of
  others runs one sampler per checkpoint, their groups concatenated;
- per batch: normalize, sample, batch metrics, then the writes, on a pool of
  threads that overlaps the next batch. Batch ``i`` draws from a device
  generator seeded from the ``i``-th draw of a host generator seeded
  ``seed``; several samplers draw from it one after another.

Members execute as ``member_chunk`` and ``same_dropout`` say
(``sampling/sampler.py``; the JAX job's two fields: ``member_chunk=None``
folds every stacked member into one forward). Runs on
``InferenceConfig.device`` (``cuda`` by default; without a card that
raises, it never falls back to the CPU).

Several ranks (``parallel/distributed.py``, one process per card): the
(data, member) mesh of :func:`_resolve_mesh` (``mesh_shape``, or the JAX
job's auto factorization of the world size), which must cover every rank.
Every rank loads the same global batch, as the single JAX process does, and
its samplers run its rows and its members (``make_sampler(..., mesh=)``),
drawing what one process would draw; the stacks gather on every rank, and
only the primary rank computes the batch metrics and writes the results
tree.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch

from ..core.checkpoint import load_checkpoint
from ..core.config import ExperimentConfig
from ..core.params import flax_to_torch, flax_to_torch_stacked, stack_states
from ..data.augment import normalize_batch
from ..data.dataset import MultiRaterDataset
from ..data.loader import BatchLoader
from ..models import swag as swag_lib
from ..models.factory import build_model
from ..parallel.distributed import is_primary, process_info
from ..parallel.mesh import make_mesh
from ..sampling.sampler import PredictionStack, SamplerMeta, SamplerSpec, make_sampler
from ..sampling.tta import TTAConfig
from .batch_metrics import make_batch_metrics
from .results import ResultsWriter, result_split_dir

METRIC_KEYS = ("dice", "ged", "ged_bma", "max_dice_pred", "max_dice_gt", "major_dice")


@dataclasses.dataclass
class InferenceConfig:
    n_pred: int = 10
    n_models: int = 10
    tta: bool = False
    same_dropout: bool = False
    discretize: bool = False
    direct_au: bool = False
    use_ema: bool = False
    batch_size: int = 16
    seed: int = 123
    metrics_compute: tuple[str, ...] = ("dice", "ged", "ged_bma")
    save_likelihood: bool = True
    save_outputs: bool = True
    skip_existing: bool = False
    diffusion_num_steps: int | None = None
    diffusion_sampler: str | None = None
    swag_scale: float = 1.0
    swag_blockwise: bool = False
    data_input_dir: str | None = None
    save_dir: str | None = None
    version: str = "version_0"
    # members per forward (SamplerSpec.member_chunk): "auto", None (all) or
    # an int, which bounds peak memory
    member_chunk: int | str | None = "auto"
    # (data, member) mesh of the process group's ranks: None -> auto (see
    # _resolve_mesh), (1, 1) -> every rank runs the whole job
    mesh_shape: tuple[int, int] | None = None
    device: str = "cuda"


def _resolve_mesh(mesh_shape: tuple[int, int] | None, batch_size: int,
                  stacked_members: Sequence[int], world_size: int) -> tuple[int, int] | None:
    """The (data, member) shape of the job's mesh, or None for no mesh
    (the JAX ``_resolve_mesh`` as a function of the world size).

    Explicit ``mesh_shape``: None when it has one device; the batch must
    split over ``data`` and every stacked source's members over ``member``.
    Auto (None, more than one rank): among (d, m) with d * m <= the world
    size, ``batch_size % d == 0`` and m == 1 or m dividing every stacked
    source's member count, the one using the most ranks, then the larger
    data axis; None when that is (1, 1). A shape that leaves ranks out is
    refused when the mesh is built (``parallel/mesh.py::Mesh``)."""

    def member_ok(m: int) -> bool:
        return m == 1 or (bool(stacked_members) and all(n % m == 0 for n in stacked_members))

    if mesh_shape is not None:
        d, m = int(mesh_shape[0]), int(mesh_shape[1])
        if d * m <= 1:
            return None
        if batch_size % d != 0:
            raise ValueError(f"batch_size {batch_size} not divisible by mesh data axis {d}")
        if not member_ok(m):
            raise ValueError(f"mesh member axis {m} must divide every stacked source's member "
                             f"count (have {list(stacked_members)})")
        return d, m
    if world_size <= 1:
        return None
    best = (1, 1)
    for d in range(1, world_size + 1):
        if batch_size % d:
            continue
        for m in range(1, world_size // d + 1):
            if member_ok(m) and (d * m, d) > (best[0] * best[1], best[0]):
                best = (d, m)
    return None if best == (1, 1) else best


def _tta_config(aug) -> TTAConfig:
    """The TTA draw of the data config's augmentations, magnitudes scaled by
    ``augment_mult`` (when positive), as the JAX ``TTAConfig.effective``."""
    m = aug.augment_mult if aug.augment_mult > 0 else 1.0
    return TTAConfig(hflip_p=min(1.0, aug.hflip_p * m), rotation_limit=aug.rotation_limit * m,
                     scale_limit=(aug.scale_limit[0] * m, aug.scale_limit[1] * m))


def _to(state: dict[str, torch.Tensor], device) -> dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in state.items()}


class UncertaintyInference:
    """Load checkpoint(s), expand EU members, run prediction + metrics + writes."""

    def __init__(self, checkpoint_paths: Sequence[str | Path], icfg: InferenceConfig):
        if not checkpoint_paths:
            raise ValueError("at least one checkpoint path required")
        self.icfg = icfg
        self.device = torch.device(icfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the inference job runs on cuda but torch.cuda.is_available() "
                               "is False; pass device='cpu' (--device cpu) to run on the CPU")
        states, configs, metas = zip(*(load_checkpoint(p) for p in checkpoint_paths))
        self.cfg: ExperimentConfig = configs[0]
        self.epoch = int(metas[0]["epoch"])
        builts = [build_model(c, device=self.device) for c in configs]
        self.built = builts[0]
        weights = [flax_to_torch(self.pick_params(s)) for s in states]

        if len(weights) > 1:
            classes = {c.network.out_channels for c in configs}
            if len(classes) != 1:
                raise ValueError(f"ensemble checkpoints disagree on num_classes: "
                                 f"{sorted(classes)}")
        # the stacked fast path needs one architecture (AU type, EU method and
        # every leaf's shape) and a trivial EU method on every checkpoint
        shape_keys = {(c.model.au_type, c.eu_method.name,
                       tuple((k, tuple(v.shape)) for k, v in w.items()))
                      for c, w in zip(configs, weights)}
        homogeneous = (len(weights) > 1 and len(shape_keys) == 1
                       and all(b.eu_type in ("none", "ensemble") for b in builts))

        self.sources: list[dict] = []
        if homogeneous:
            stack = _to(stack_states(weights, self.built.module), self.device)
            self._add_source(self.built, "params_stack", len(weights), False, stack)
        elif len(weights) == 1:
            mode, n, members = self._expand_eu(self.built, self.cfg, states[0], weights[0])
            self._add_source(self.built, mode, n, False, members)
        else:
            # a heterogeneous ensemble: one sampler per checkpoint, groups
            # concatenated. Group sizes must agree across samplers: when every
            # member draws n_pred samples (generative, or softmax with TTA) and
            # there is more than one such member, each member keeps its group;
            # any single-sample member forces singleton groups on all.
            expanded = [self._expand_eu(b, c, s, w)
                        for b, c, s, w in zip(builts, configs, states, weights)]
            sizes = [icfg.n_pred if (b.is_generative or (b.au_type == "softmax" and icfg.tta))
                     else 1 for b in builts]
            gen_members = sum(n for (_, n, _), sz in zip(expanded, sizes) if sz > 1)
            keep_groups = (len(set(sizes)) == 1 and sizes[0] > 1 and gen_members > 1
                           and not icfg.direct_au)
            for built, (mode, n, members), sz in zip(builts, expanded, sizes):
                external = gen_members - (n if sz > 1 else 0) if keep_groups else 0
                self._add_source(built, mode, n, not keep_groups, members, external)

        # batches split over the mesh's data axis, stacked members over member
        stacked = [src["spec"].n_members for src in self.sources
                   if src["spec"].member_mode == "params_stack"]
        shape = _resolve_mesh(icfg.mesh_shape, icfg.batch_size, stacked, process_info()[1])
        self.mesh = make_mesh(shape) if shape is not None else None
        for src in self.sources:
            src["sampler"] = make_sampler(src["built"], src["spec"], members=src.pop("members"),
                                          mesh=self.mesh)
        metas_ = [src["sampler"].meta for src in self.sources]
        assert len({m.samples_per_group for m in metas_}) == 1
        self.meta = SamplerMeta(
            n_groups=sum(m.n_groups for m in metas_),
            samples_per_group=metas_[0].samples_per_group,
            group_is_generative=tuple(g for m in metas_ for g in m.group_is_generative))
        self.spec = self.sources[0]["spec"]
        self.sampler = self.sources[0]["sampler"]
        self.metrics_fn = make_batch_metrics(
            num_classes=self.built.num_classes, ignore_index=self.cfg.data.ignore_index,
            meta=self.meta, compute_dice="dice" in icfg.metrics_compute,
            compute_ged="ged" in icfg.metrics_compute,
            compute_ged_bma="ged_bma" in icfg.metrics_compute,
            compute_likelihood=icfg.save_likelihood)

    # ---- members ----------------------------------------------------------

    def pick_params(self, state: dict) -> dict:
        """The flax variables to run: EMA ones with ``use_ema``, else
        ``params``, else (an EMA-only snapshot) ``ema_params``."""
        if self.icfg.use_ema:
            if "ema_params" not in state:
                raise ValueError("use_ema requested but checkpoint has no ema_params")
            return state["ema_params"]
        return state["params"] if "params" in state else state["ema_params"]

    def _expand_eu(self, built, cfg: ExperimentConfig, state: dict, weights: dict):
        """One checkpoint -> (member_mode, n_members, member stack or its own
        weights); the module gets its weights here."""
        icfg = self.icfg
        if built.eu_type in ("swag", "swag_diag"):
            raw = state.get("swag_state")
            if raw is None:
                raise ValueError("SWAG checkpoint lacks swag_state")
            posterior = swag_lib.SwagState(
                n_models=int(raw["n_models"]),
                mean=_to(flax_to_torch(raw["mean"]), self.device),
                sq_mean=_to(flax_to_torch(raw["sq_mean"]), self.device),
                dev=_to(flax_to_torch_stacked(raw["dev"]), self.device) if "dev" in raw else None)
            members = swag_lib.sample_members(
                posterior, torch.Generator(self.device).manual_seed(icfg.seed), icfg.n_models,
                max_num_models=cfg.eu_method.swag.max_snapshots, scale=icfg.swag_scale,
                use_low_rank=built.eu_type == "swag", blockwise=icfg.swag_blockwise,
                var_clamp=cfg.eu_method.swag.min_variance)
            return "params_stack", icfg.n_models, members
        built.module.load_state_dict(weights, strict=True)
        if built.eu_type == "dropout":
            return "dropout", icfg.n_models, None
        return "single", 1, None

    def _add_source(self, built, member_mode: str, n_members: int, force_singletons: bool,
                    members: dict | None, external_generative_members: int = 0) -> None:
        icfg = self.icfg
        spec = SamplerSpec(
            n_pred=icfg.n_pred, n_members=n_members, member_mode=member_mode, tta=icfg.tta,
            tta_config=_tta_config(self.cfg.data.augmentations),
            same_dropout=icfg.same_dropout, discretize=icfg.discretize,
            direct_au=icfg.direct_au or force_singletons,
            member_chunk=icfg.member_chunk,
            external_generative_members=external_generative_members,
            diffusion_num_steps=icfg.diffusion_num_steps,
            diffusion_sampler=icfg.diffusion_sampler)
        self.sources.append({"built": built, "spec": spec, "members": members})

    # ---- prediction -------------------------------------------------------

    def batch_generators(self) -> Iterator[torch.Generator]:
        """One device generator per batch, each seeded from the next draw of
        a host generator seeded ``seed``."""
        host = torch.Generator().manual_seed(self.icfg.seed)
        while True:
            seed = int(torch.randint(2 ** 62, (1,), generator=host))
            yield torch.Generator(self.device).manual_seed(seed)

    def _sample_stack(self, images: torch.Tensor, generator: torch.Generator) -> PredictionStack:
        """Run every sampler and concatenate their group stacks (float32)."""
        stacks = [src["sampler"](images, generator) for src in self.sources]
        if len(stacks) == 1:
            return PredictionStack(*(t.float() for t in stacks[0]))
        group_means = torch.cat([s.group_means.float() for s in stacks])
        return PredictionStack(torch.cat([s.groups.float() for s in stacks]), group_means,
                               group_means.mean(dim=0))

    def normalize(self, images: np.ndarray) -> torch.Tensor:
        aug = self.cfg.data.augmentations
        return normalize_batch(torch.from_numpy(images).to(self.device), aug.mean, aug.std)

    # ---- data and results -------------------------------------------------

    def _dataset(self, split: str) -> MultiRaterDataset:
        data_dir = self.icfg.data_input_dir or self.cfg.data.data_input_dir
        splits_path = self.cfg.data.splits_path or (
            Path(data_dir) / "splits" / self.cfg.data.split_name / "firstCycle" / "splits.pkl")
        return MultiRaterDataset(splits_path, data_dir, split=split,
                                 data_fold_id=self.cfg.data.data_fold_id,
                                 return_all_raters=True)

    def split_dir(self, split: str) -> Path:
        return result_split_dir(self.icfg.save_dir or self.cfg.save_dir, self.cfg.auto_exp_name,
                                self.icfg.n_pred, self.icfg.version, self.epoch,
                                self.icfg.use_ema, split)

    def run_split(self, split: str) -> dict:
        out_dir = self.split_dir(split)
        if self.icfg.skip_existing and (out_dir / "metrics.json").exists():
            return {"skipped": True, "split": split}
        loader = BatchLoader(self._dataset(split), self.icfg.batch_size, drop_last=False)
        t0 = time.time()
        if is_primary():
            # aborts the write pool if the loop raises; joins it and writes
            # metrics.json on success
            with ResultsWriter(out_dir, binary=self.built.num_classes == 2) as writer:
                n_images = self._run_split_loop(loader, writer)
        else:  # the other ranks sample their parts and write nothing
            n_images = self._run_split_loop(loader, None)
        elapsed = time.time() - t0
        return {"split": split, "n_images": n_images, "seconds": elapsed,
                "images_per_sec": n_images / elapsed if elapsed > 0 else float("nan"),
                "out_dir": str(out_dir)}

    def _run_split_loop(self, loader, writer) -> int:
        icfg = self.icfg
        ign = self.cfg.data.ignore_index
        n_images = 0
        for batch, generator in zip(loader, self.batch_generators()):
            stack = self._sample_stack(self.normalize(batch["image"]), generator)
            if writer is None:
                n_images += int(np.count_nonzero(batch["valid"]))
                continue
            gt = torch.from_numpy(batch["seg"]).to(self.device)
            results = self.metrics_fn(stack, gt, torch.from_numpy(batch["num_raters"])
                                      .to(self.device))
            results = {k: ({m: t.cpu().numpy() for m, t in v.items()} if isinstance(v, dict)
                           else v.cpu().numpy()) for k, v in results.items()}
            for i in np.nonzero(batch["valid"])[0]:
                image_id, dataset = batch["image_id"][i], batch["dataset"][i]
                writer.add_metrics(image_id, dataset, {k: float(results[k][i])
                                                       for k in METRIC_KEYS if k in results})
                if icfg.save_likelihood and "mean_NLL" in results:
                    n_r = int(batch["num_raters"][i])
                    rec = {"gt_model_NLL": results["gt_model_NLL"][i][:n_r].tolist(),
                           "gt_NLL": results["gt_NLL"][i][:n_r].tolist(),
                           "mean_NLL": float(results["mean_NLL"][i])}
                    if "gen_NLL" in results:
                        rec["gen_NLL"] = float(results["gen_NLL"][i])
                    writer.add_likelihood(image_id, dataset, rec)
                if icfg.save_outputs:
                    ignore_mask = None if ign is None or ign == 0 else batch["seg"][i][0] == ign
                    writer.save_prediction(image_id, results["group_idx"][i],
                                           results["mean_idx"][i], ignore_mask)
                    writer.save_uncertainty(image_id, {k: v[i] for k, v in
                                                       results["heatmaps"].items()})
                n_images += 1
        return n_images

    def run(self, splits: Sequence[str]) -> list[dict]:
        return [self.run_split(s) for s in splits]

    def collect_raw_predictions(self, split: str, *, num_images: int | None = None,
                                prefer_nonempty: bool = True, seed: int | None = None) -> dict:
        """Unreduced prediction stacks of a sampled subset of a split: images
        drawn with ``np.random.default_rng(seed)`` (default the job's seed),
        preferring the images whose raters mark the most pixels; host arrays
        {image_id, image, gt, groups (G, S, H, W, C), mean}."""
        ds = self._dataset(split)
        rng = np.random.default_rng(self.icfg.seed if seed is None else seed)
        idxs = np.arange(len(ds))
        if num_images is not None and num_images < len(ds):
            if prefer_nonempty:
                areas = np.array([float(np.sum(ds.load(int(i))["seg"])) for i in idxs])
                pool = np.argsort(areas)[::-1][:num_images * 3]
                idxs = rng.choice(pool, size=num_images, replace=False)
            else:
                idxs = rng.choice(idxs, size=num_images, replace=False)
        records = []
        for i, generator in zip(idxs, self.batch_generators()):
            sample = ds.load(int(i))
            stack = self._sample_stack(self.normalize(sample["image"][None]), generator)
            records.append({"image_id": sample["image_id"], "image": sample["image"],
                            "gt": sample["seg"], "groups": stack.groups[:, :, 0].cpu().numpy(),
                            "mean": stack.mean[0].cpu().numpy()})
        return {"split": split, "records": records,
                "group_is_generative": self.meta.group_is_generative}
