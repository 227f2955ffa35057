"""Training loop (port of ``diffuncertainty_tpu/train/loop.py``): the step,
EMA, SWAG collection, validation and checkpoints, for the softmax,
diffusion, SSN and prob-U-Net families on the DiffUnet and the softmax and
SSN families on the HRNet.

- One step: the augmentation (single-rater targets) or the normalization
  (multi-rater targets), the forward and the loss, the gradients of every
  parameter, clipping by the global norm with optax's rule (unchanged below
  ``gradient_clip_val``, else scaled by ``gradient_clip_val / norm``), then
  AdamW with optax's math (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, decoupled
  ``weight_decay``, the learning rate of the step's count under the none,
  linear or cosine schedule over optimizer steps), then the EMA lerp with the
  first-step copy. ``grad_norm`` in the step's aux is the norm before the clip.
- The HRNet's BatchNorm statistics (``TrainState.model_state``, the
  module's running_mean/running_var buffers by state_dict name): the loss
  runs the network in train mode and returns the running statistics after
  the batch, which the step writes into the buffers once the optimizer has
  run, as the JAX step replaces ``model_state`` with flax's updated
  ``batch_stats``. The EMA covers the parameters only; the ``last``
  checkpoint, the scheduled snapshots and the EMA weights all carry the raw
  run's statistics beside them (``batch_stats``, as the JAX trainer merges
  them). Validation's loss runs in train mode on the batch's statistics and
  drops their update; its prediction uses the running statistics.
- ``trainer.remat``: the loss's forward (not the input pipeline) runs under
  ``torch.utils.checkpoint`` (non-reentrant), as the JAX step wraps its loss
  in ``jax.checkpoint``; the recompute in the backward starts from the
  explicit generator's state at the forward's start and puts the generator
  back as it found it (:func:`generator_replay`), so it redraws the same
  dropout masks, rater, diffusion times and noise, SSN draws and prob-U-Net
  latents, and the gradients equal the stored forward's. The recompute
  launches both kernels' forwards a second time.
- SWAG snapshots at epoch end, on the reference schedule (``start =
  (max_epochs - 1) - freq * (K - 1)``, every ``freq``).
- ``last`` full checkpoints and scheduled weight snapshots (EMA-only when
  configured), in the flax layout the JAX trainer writes
  (``core/checkpoint.py``); the graceful wall-clock stop.
- Per epoch (:meth:`Trainer.set_epoch`): the prob-U-Net's beta from its
  warm-up, and the SSN's mean-only loss (no factor head, whose parameters
  then get a zero gradient) for ``epoch < ssn_pretrain_epochs``. The epoch's
  record adds ``train_cov_failed`` (SSN: the share of elements whose
  covariance failed) and ``beta`` (prob-U-Net) to the JAX trainer's keys.
- Validation predicts one mean per family: the softmax of the logits
  (softmax, SSN), the decode at the prior's mean (prob-U-Net), or the x0 of
  one reverse trajectory with the config's sampler and steps (diffusion),
  which goes into the argmax and the GED as it is, as in the JAX trainer.

Data parallel (``trainer.mesh_shape`` (d, m) with d * m ranks, one process
per card; ``parallel/``): the state is replicated (rank 0's initial weights
broadcast), each rank runs the step on its rows of the global batch (the
CLI's loaders take ``loader_shard``), drawing what one process would draw
for them (``parallel/mesh.py::ShardedGenerator``), and the gradients are
averaged over the ``data`` axis before the clip; a loss normalized by a
count of valid pixels divides by the rank's share of the global count
(``train/losses.py::global_count``), and the HRNet's train-mode BatchNorm
takes its moments over the global batch (``models/hrnet.py::
sync_batch_stats``), as JAX's jit of the global step does. A member axis
replicates. Validation shards each val batch over ``data`` as the step
does (every rank loads the whole batch and keeps its rows; the loss is the
global batch's, the per-image Dice and GED are gathered), so every rank
logs the single process's numbers; a batch that does not split over the
axis (a short tail) runs whole on every rank, as the JAX trainer leaves
such a batch unsharded. Checkpoints and the metric log are the primary
rank's.

Parameters stay float32 in the module; ``trainer.precision=bf16`` runs the
forward in bf16 through both hand-written kernels, whose backwards are their
twins' VJPs (``ops/cuda_attention.py``, ``ops/cuda_groupnorm.py``).

Randomness: the initial weights come from a CPU generator seeded with
``cfg.seed`` (``models/unet.py::flax_init_``), so they are the same on the
CPU and the card; each epoch's augmentation, dropout and rater draws come
from one generator on the device seeded from ``(seed, epoch)``, so a run
resumed at an epoch draws what the uninterrupted run draws; validation draws
from a generator seeded ``seed + 1000 + epoch`` (sharded rows through
``ShardedGenerator``: the single process's draws).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..core.checkpoint import save_checkpoint, scheduled_epochs
from ..core.config import ExperimentConfig
from ..core.params import flax_to_torch, flax_to_torch_stacked, torch_to_flax
from ..data.augment import TrainAugmentConfig, augment_batch, normalize_batch
from ..metrics.dice import dice_bin, dice_multiclass_micro
from ..metrics.ged import ged_binary
from ..models import diffusion as diffusion_lib
from ..models import swag as swag_lib
from ..models.factory import BuiltModel, build_model
from ..models.hrnet import sync_batch_stats
from ..models.unet import flax_init_
from ..parallel.distributed import is_primary
from ..parallel.mesh import ShardedGenerator, gather, make_mesh, replicate
from .losses import make_loss_fn

State = dict[str, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, as the JAX trainer takes them


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the update count and the moments."""

    count: int
    mu: State
    nu: State


class TrainState(NamedTuple):
    step: int
    params: State  # the module's own float32 parameters, by state_dict name
    opt_state: AdamState
    ema_params: State | None  # None when EMA is off
    # the HRNet's BatchNorm statistics: the module's buffers by state_dict
    # name (None for the DiffUnet families)
    model_state: State | None = None


def generator_replay(generator: torch.Generator):
    """``context_fn`` of ``torch.utils.checkpoint``: no context around the
    forward, and around the recompute one that starts ``generator`` where
    the forward started it and leaves it as it found it."""
    start = generator.get_state()

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state()
        generator.set_state(start)
        try:
            yield
        finally:
            generator.set_state(now)

    return contextlib.nullcontext(), recompute()


@torch.no_grad()
def adam_(params: list[torch.Tensor], grads: list[torch.Tensor], mu: list[torch.Tensor],
          nu: list[torch.Tensor], count: int, lr: float, weight_decay: float = 0.0) -> None:
    """optax's adam (adamw with ``weight_decay``) update number ``count``
    (from 1), in place on the parameters and the moments; the bias
    corrections in the parameters' float type, as optax takes them."""
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
    ft = np.float64 if params[0].dtype == torch.float64 else np.float32
    mu_hat = torch._foreach_div(mu, float(ft(1) - ft(B1) ** count))
    denom = torch._foreach_div(nu, float(ft(1) - ft(B2) ** count))
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    updates = torch._foreach_div(mu_hat, denom)
    if weight_decay:
        torch._foreach_add_(updates, params, alpha=weight_decay)
    torch._foreach_add_(params, updates, alpha=-lr)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, workdir: str | Path | None = None,
                 device: str | torch.device = "cuda", built: BuiltModel | None = None):
        """``built``: the model to train (by default ``build_model(cfg)`` on
        ``device``), as the JAX trainer takes one."""
        tr = cfg.trainer
        self.mesh = (make_mesh(tuple(tr.mesh_shape), tuple(tr.mesh_axis_names))
                     if tr.mesh_shape is not None and int(np.prod(tr.mesh_shape)) > 1 else None)
        self.data_group = self.mesh.group("data") if self.mesh is not None else None
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: CUDA requested but torch.cuda.is_available() is False; "
                               "pass device='cpu' to train on the CPU")
        self.built: BuiltModel = built or build_model(cfg, device=self.device)
        # by ssn_mean_only (only the SSN's pretraining epochs take True)
        self._loss_fns = {mean_only: make_loss_fn(
            self.built, ignore_index=cfg.data.ignore_index,
            n_aleatoric_samples=cfg.model.n_aleatoric_samples, ssn_mean_only=mean_only,
            data_group=self.data_group) for mean_only in (False, True)}
        # validation: the batches that split over the data axis (its group)
        # and those that every rank runs whole (None)
        self._eval_loss_fns = {group: make_loss_fn(
            self.built, ignore_index=cfg.data.ignore_index,
            n_aleatoric_samples=cfg.model.n_aleatoric_samples, data_group=group)
            for group in {None, self.data_group}}
        self.set_epoch(0)
        self.workdir = Path(workdir) if workdir is not None else (
            Path(cfg.save_dir) / cfg.auto_exp_name / str(cfg.version or "version_0"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        aug = cfg.data.augmentations
        self.aug_cfg = TrainAugmentConfig(
            hflip_p=aug.hflip_p, rotation_limit=aug.rotation_limit,
            scale_limit=tuple(aug.scale_limit),
            gauss_noise_var_limit=tuple(aug.gauss_noise_var_limit),
            gauss_noise_p=aug.gauss_noise_p, mean=tuple(aug.mean), std=tuple(aug.std),
            augment_mult=aug.augment_mult)
        self.total_steps = tr.lr_schedule_total_steps or max(tr.max_epochs, 1)
        self.track_ema = cfg.ema.track_ema_weights
        swag_cfg = cfg.eu_method.swag
        self.swag_enabled = swag_cfg.enabled
        self.swag_state: swag_lib.SwagState | None = None
        if self.swag_enabled:
            freq = max(1, swag_cfg.snapshot_frequency)
            self.swag_freq = freq
            self.swag_start_epoch = max(tr.max_epochs - 1 - freq * max(swag_cfg.max_snapshots - 1,
                                                                      0), 0)
        self._logger = None
        # host wall time of each step of fit, loading included (the loop does
        # not wait for the card, so a step's time is what it holds the host)
        self.step_seconds: list[float] = []

    # ---- state ----------------------------------------------------------

    def init_state(self, generator: torch.Generator | None = None) -> TrainState:
        """The flax initialization of the family's module (from a CPU
        generator seeded ``cfg.seed`` unless one is given; the diffusion
        DiffUnet takes ``num_classes`` + image channels, the prob-U-Net's
        posterior the image and its one-hot target; the HRNet's statistics
        mean 0 and variance 1), zero moments, the EMA a copy of the weights."""
        module = self.built.module
        flax_init_(module, generator or torch.Generator().manual_seed(self.cfg.seed))
        return self.fresh_state()

    def fresh_state(self) -> TrainState:
        """The module's current weights (and BatchNorm statistics) with a
        fresh optimizer (step 0), the EMA a copy of them, fresh SWAG moments."""
        params = replicate(dict(self.built.module.named_parameters()), self.mesh)
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        ema = {k: p.detach().clone() for k, p in params.items()} if self.track_ema else None
        self._init_swag(params)
        return TrainState(0, params, AdamState(0, zeros, {k: v.clone() for k, v in zeros.items()}),
                          ema, self._model_state())

    def _model_state(self) -> State | None:
        """The HRNet's BatchNorm buffers (the module's own tensors)."""
        if not self.built.has_batch_stats:
            return None
        return dict(self.built.module.named_buffers())

    def _init_swag(self, params: State) -> None:
        if self.swag_enabled:
            swag_cfg = self.cfg.eu_method.swag
            self.swag_state = swag_lib.init({k: p.detach() for k, p in params.items()},
                                            swag_cfg.max_snapshots, diag_only=swag_cfg.diag_only)

    def restore_state(self, saved: dict) -> TrainState:
        """The state of a ``last`` checkpoint (numpy leaves in the flax
        layout): weights and BatchNorm statistics, AdamW moments and count,
        step, EMA, SWAG moments."""
        dev = self.device
        module = self.built.module
        module.load_state_dict(flax_to_torch(saved["params"]), strict=True)
        params = dict(module.named_parameters())

        def on_device(tree):  # in each parameter's dtype
            return {k: v.to(dev, params[k].dtype if k in params else v.dtype)
                    for k, v in flax_to_torch(tree).items()}

        opt = saved["opt_state"]
        opt_state = AdamState(int(opt["count"]), on_device(opt["mu"]), on_device(opt["nu"]))
        ema = None
        if self.track_ema and "ema_params" in saved:  # the parameters, not the statistics
            ema = {k: v for k, v in on_device(saved["ema_params"]).items() if k in params}
        if self.track_ema and ema is None:
            ema = {k: p.detach().clone() for k, p in params.items()}
        sw = saved.get("swag_state")
        if self.swag_enabled and sw is None:
            self._init_swag(params)
        elif self.swag_enabled:
            self.swag_state = swag_lib.SwagState(
                int(sw["n_models"]), on_device(sw["mean"]), on_device(sw["sq_mean"]),
                {k: v.to(dev) for k, v in flax_to_torch_stacked(sw["dev"]).items()}
                if "dev" in sw else None)
        return TrainState(int(saved["step"]), params, opt_state, ema, self._model_state())

    # ---- the epoch's schedule ------------------------------------------

    def sched_for_epoch(self, epoch: int) -> dict:
        """The epoch's loss schedule: the prob-U-Net's ``beta`` (float32)."""
        if self.built.au_type != "prob_unet":
            return {}
        return {"beta": float(np.float32(self.built.prob_unet_spec.beta_at_epoch(epoch)))}

    def set_epoch(self, epoch: int) -> None:
        """The loss and schedule of ``epoch`` for the steps that follow: the
        SSN trains its mean alone before ``ssn_pretrain_epochs``."""
        self.ssn_mean_only = (self.built.au_type == "ssn"
                              and epoch < self.cfg.model.ssn_pretrain_epochs)
        self.loss_fn = self._loss_fns[self.ssn_mean_only]
        self.sched = self.sched_for_epoch(epoch)

    # ---- the step -------------------------------------------------------

    def learning_rate(self, count: int) -> float:
        """The step size at optimizer count ``count``, in float32 as optax's
        schedules compute it."""
        tr = self.cfg.trainer
        lr = np.float32(tr.learning_rate)
        if tr.lr_schedule == "none":
            return float(tr.learning_rate)
        total = np.float32(self.total_steps)
        if tr.lr_schedule == "linear":  # optax.linear_schedule(lr, 0, total)
            frac = np.float32(1) - np.float32(min(max(count, 0), self.total_steps)) / total
            return float(lr * frac)
        if tr.lr_schedule == "cosine":  # optax.cosine_decay_schedule(lr, total)
            c = np.float32(min(float(count), float(self.total_steps)))
            decay = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c / total))
            return float(lr * decay)
        raise ValueError(tr.lr_schedule)

    def train_step(self, state: TrainState, batch: dict, generator: torch.Generator
                   ) -> tuple[TrainState, dict]:
        """One step on ``batch`` (data parallel: this rank's rows of the
        global batch) with the draws of ``generator``."""
        aux, grads = self.step_gradients(state, batch, generator)
        state, grad_norm = self.apply_gradients(state, grads)
        self.commit_model_state(state, aux.pop("model_state", None))
        return state, {**{k: v.detach() for k, v in aux.items()}, "grad_norm": grad_norm}

    def step_gradients(self, state: TrainState, batch: dict, generator: torch.Generator
                       ) -> tuple[dict, list[torch.Tensor]]:
        """The step's aux and gradients (``state.params`` order); data
        parallel, both averaged over the ``data`` axis, the HRNet's BatchNorm
        moments taken over the global batch (in the forward and in a remat's
        recompute)."""
        sync_batch_stats(self.built.module, self.data_group)
        try:
            loss, aux = self.forward_loss(batch, generator)
            grads = self.average_over_data(self.gradients(state, loss))
        finally:
            sync_batch_stats(self.built.module, None)
        if self.data_group is not None:
            aux["loss"] = self.average_over_data([aux["loss"].detach()])[0]
        return aux, grads

    @staticmethod
    @torch.no_grad()
    def commit_model_state(state: TrainState, update: State | None) -> None:
        """Write the step's BatchNorm statistics into the module's buffers."""
        if update is not None:
            for k, v in update.items():
                state.model_state[k].copy_(v)

    def forward_loss(self, batch: dict, generator: torch.Generator):
        """The step's input pipeline, forward and loss: (loss, aux); with
        ``trainer.remat`` the loss's forward is recomputed in the backward."""
        dev = self.device
        images = torch.as_tensor(batch["image"]).to(dev)
        seg = torch.as_tensor(batch["seg"]).to(dev)
        if self.mesh is not None:
            generator = ShardedGenerator(generator, images.shape[0], (
                self.mesh.coord("data"), self.mesh.size("data")))
        if seg.ndim == 3:  # single-rater targets: the whole train pipeline
            images, seg = augment_batch(self.aug_cfg, generator, images, seg)
        else:  # multi-rater targets: normalize only
            images = normalize_batch(images, self.aug_cfg.mean, self.aug_cfg.std)
        args = (self.built.module, {"image": images, "seg": seg}, generator, self.sched)
        if not self.cfg.trainer.remat:
            return self.loss_fn(*args)
        return torch.utils.checkpoint.checkpoint(
            self.loss_fn, *args, use_reentrant=False,
            context_fn=functools.partial(generator_replay, generator))

    def average_over_data(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The mean of each tensor over the ``data`` axis (one all-reduce of
        them all); the tensors themselves without a data axis."""
        if self.data_group is None:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        torch.distributed.all_reduce(flat, group=self.data_group)
        flat /= self.mesh.size("data")
        return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in tensors]),
                                                    tensors)]

    def gradients(self, state: TrainState, loss: torch.Tensor) -> list[torch.Tensor]:
        """d(loss)/d(every parameter), in ``state.params`` order (zeros for
        a parameter the loss does not reach)."""
        params = list(state.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    def apply_gradients(self, state: TrainState, grads: list[torch.Tensor]
                        ) -> tuple[TrainState, torch.Tensor]:
        """Clip, AdamW and the EMA, in place; the next state and the norm of
        ``grads`` before the clip."""
        names = list(state.params)
        params = [state.params[k] for k in names]
        grad_norm = self._adamw(state, names, params, grads)
        if state.ema_params is not None:
            # decay-average with the first-step copy
            w = 0.0 if state.step == 0 else self.cfg.ema.ema_decay
            ema = [state.ema_params[k] for k in names]
            with torch.no_grad():
                torch._foreach_mul_(ema, w)
                torch._foreach_add_(ema, params, alpha=1.0 - w)
        opt = state.opt_state
        return state._replace(step=state.step + 1, opt_state=opt._replace(count=opt.count + 1)
                              ), grad_norm

    @torch.no_grad()
    def _adamw(self, state: TrainState, names: list[str], params: list[torch.Tensor],
               grads: list[torch.Tensor]) -> torch.Tensor:
        """clip_by_global_norm then adamw, in place on the parameters and the
        moments; returns the norm before the clip."""
        max_norm = float(self.cfg.trainer.gradient_clip_val)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, factor)
        opt = state.opt_state
        adam_(params, grads, [opt.mu[k] for k in names], [opt.nu[k] for k in names],
              opt.count + 1, self.learning_rate(opt.count),
              float(self.cfg.trainer.weight_decay))
        return norm

    def epoch_generator(self, epoch: int) -> torch.Generator:
        """The generator of one epoch's training draws, seeded from (seed, epoch)."""
        seed = int(np.random.default_rng((self.cfg.seed, epoch, 2)).integers(2**63))
        return torch.Generator(self.device).manual_seed(seed)

    # ---- SWAG and validation -------------------------------------------

    def _maybe_collect_swag(self, state: TrainState, epoch: int) -> bool:
        swag_cfg = self.cfg.eu_method.swag
        if (not self.swag_enabled or self.swag_state.n_models >= swag_cfg.max_snapshots
                or epoch < self.swag_start_epoch
                or (epoch - self.swag_start_epoch) % self.swag_freq):
            return False
        with torch.no_grad():
            self.swag_state = swag_lib.collect(
                self.swag_state, {k: p.detach() for k, p in state.params.items()},
                max_num_models=swag_cfg.max_snapshots)
        return True

    def _mean_prediction(self, module, images: torch.Tensor,
                         generator: torch.Generator) -> torch.Tensor:
        """The family's one prediction of validation: probabilities, or the
        x0 of one reverse trajectory (diffusion)."""
        built = self.built
        if built.au_type in ("softmax", "ssn"):
            return torch.softmax(module(images, generator).logits.float(), dim=-1)
        if built.au_type == "prob_unet":
            out = module(images, generator=generator)
            return torch.softmax(module.decode(out.features, out.prior.mu).float(), dim=-1)
        b, h, w, _ = images.shape
        x_init = diffusion_lib.draw_eps((b, h, w, built.num_classes), generator, images.dtype)

        def model_fn(x_with_im, t, gen):
            return module(x_with_im, gen, timesteps=t).logits

        return built.diffusion.sample_loop(model_fn, x_init, images, built.diffusion_num_steps,
                                           generator, sampler_type=built.diffusion_sampler_type)

    @torch.no_grad()
    def evaluate(self, state: TrainState, loader, *, epoch: int, use_ema: bool = False) -> dict:
        """``val_loss`` (the full loss with the epoch's schedule), ``val_dice``
        (of the argmax of one mean prediction, the mean over raters) and, for
        binary multi-rater targets, ``val_ged``. With ``use_ema``, a copy of
        the module holding the EMA weights (and the run's BatchNorm
        statistics) predicts. The HRNet's loss runs in train mode and its
        statistics' update is dropped; its prediction uses the running ones.
        Data parallel, each batch that splits over ``data`` runs sharded
        (see the module's docstring)."""
        module = self.built.module
        if use_ema and state.ema_params is not None:
            module = copy.deepcopy(module)
            module.load_state_dict({**state.ema_params, **(state.model_state or {})})
        sched = self.sched_for_epoch(epoch)
        dev = self.device
        num_classes = self.built.num_classes
        ignore = self.cfg.data.ignore_index
        ged_ignore = ignore if ignore is not None and ignore >= 0 else None
        generator = torch.Generator(dev).manual_seed(self.cfg.seed + 1000 + epoch)
        data = self.mesh.size("data") if self.mesh is not None else 1
        losses, dices, geds = [], [], []
        for batch in loader:
            images = normalize_batch(torch.as_tensor(batch["image"]).to(dev), self.aug_cfg.mean,
                                     self.aug_cfg.std)
            seg = torch.as_tensor(batch["seg"]).to(dev)
            split = data > 1 and images.shape[0] % data == 0
            group, gen = None, generator
            if split:  # this rank's rows, with the draws one process makes for them
                rows = self.mesh.rows(images.shape[0], "data")
                images, seg = images[rows], seg[rows]
                group = self.data_group
                gen = ShardedGenerator(generator, images.shape[0],
                                       (self.mesh.coord("data"), data))
            sync_batch_stats(module, group)
            try:
                loss, _ = self._eval_loss_fns[group](module, {"image": images, "seg": seg}, gen,
                                                     sched)
            finally:
                sync_batch_stats(module, None)
            probs = self._mean_prediction(module, images, gen)
            pred_idx = probs.argmax(dim=-1)
            seg4 = seg[:, None] if seg.ndim == 3 else seg
            if num_classes == 2:
                d = dice_bin(pred_idx[:, None], seg4)
            else:
                d = dice_multiclass_micro(pred_idx[:, None], seg4, num_classes,
                                          ignore_index=ignore)
            per_image = {"dice": d.mean(dim=1)}
            if seg4.shape[1] > 1 and num_classes == 2:
                per_image["ged"] = ged_binary(probs[:, None], seg4, ignore_index=ged_ignore)["ged"]
            if split:  # the global batch's loss and per-image metrics
                loss = self.average_over_data([loss.detach()])[0]
                per_image = {k: gather(v, self.mesh, "data") for k, v in per_image.items()}
            valid = torch.as_tensor(np.asarray(batch["valid"]), device=dev)
            losses.append(float(loss))
            dices.extend(per_image["dice"][valid].tolist())
            if "ged" in per_image:
                geds.extend(per_image["ged"][valid].tolist())
        out = {"val_loss": float(np.mean(losses)), "val_dice": float(np.mean(dices))}
        if geds:
            out["val_ged"] = float(np.mean(geds))
        return out

    # ---- fit -------------------------------------------------------------

    def fit(self, train_loader, val_loader=None, *, train_eval_loader=None,
            resume_state: TrainState | None = None, start_epoch: int = 0) -> TrainState:
        cfg = self.cfg
        t_start = time.time()
        shutdown_after = (cfg.ckpt_save_freq.shutdown_timer if cfg.ckpt_save_freq.do_shutdown
                          else None)
        if cfg.trainer.lr_schedule != "none" and cfg.trainer.lr_schedule_total_steps == 0:
            # the schedule counts optimizer steps; a resumed run counts the same
            self.total_steps = cfg.trainer.max_epochs * max(len(train_loader), 1)
        sched = cfg.ckpt_save_freq
        snapshot_epochs = set(scheduled_epochs(
            max_epochs=cfg.trainer.max_epochs, use_linear=sched.use_linear_saving,
            linear_freq=sched.linear_freq, use_exponential=sched.use_exponential_saving,
            exponent_base=sched.exponent_base, exponential_start=sched.exponential_start))
        state = resume_state
        for epoch in range(start_epoch, cfg.trainer.max_epochs):
            train_loader.set_epoch(epoch)
            self.set_epoch(epoch)
            generator = self.epoch_generator(epoch)
            losses, failed = [], []
            t_step = time.perf_counter()
            for batch in train_loader:
                if state is None:
                    state = self.init_state()
                state, aux = self.train_step(state, batch, generator)
                losses.append(aux["loss"])
                if "cov_failed" in aux:
                    failed.append(aux["cov_failed"])
                now = time.perf_counter()
                self.step_seconds.append(now - t_step)
                t_step = now
            log = {"epoch": epoch, "train_loss": float(torch.stack(losses).mean())}
            if failed:
                log["train_cov_failed"] = float(torch.stack(failed).mean())
            log.update(self.sched)
            self._maybe_collect_swag(state, epoch)
            if val_loader is not None and (epoch + 1) % cfg.trainer.val_every_n_epochs == 0:
                log.update(self.evaluate(state, val_loader, epoch=epoch))
                if train_eval_loader is not None:
                    tm = self.evaluate(state, train_eval_loader, epoch=epoch)
                    log.update({f"train_eval_{k.removeprefix('val_')}": v for k, v in tm.items()})
            self._log(log)
            if epoch in snapshot_epochs:
                self._save_scheduled(state, epoch)
            saved_last = ((epoch + 1) % max(1, sched.last_every_n_epochs) == 0
                          or epoch == cfg.trainer.max_epochs - 1)
            if saved_last:
                self._save_last(state, epoch)
            if shutdown_after is not None and time.time() - t_start > shutdown_after:
                if not saved_last:
                    self._save_last(state, epoch)
                self._log({"epoch": epoch, "event": "graceful_shutdown"})
                break
        if self._logger is not None:
            self._logger.close()
            self._logger = None
        return state

    # ---- checkpoints -------------------------------------------------------

    def _ckpt_dir(self) -> Path:
        return self.workdir / "checkpoints"

    def full_state_dict(self, state: TrainState) -> dict:
        """The ``last`` checkpoint's state, in the JAX trainer's key layout
        (``params`` and ``ema_params`` with the run's ``batch_stats``)."""
        opt = state.opt_state
        ms = state.model_state or {}
        d = {"params": torch_to_flax({**state.params, **ms}),
             "opt_state": {"count": np.asarray(opt.count, np.int32),
                           "mu": torch_to_flax(opt.mu), "nu": torch_to_flax(opt.nu)},
             "step": np.asarray(state.step, np.int32)}
        if state.ema_params is not None:
            d["ema_params"] = torch_to_flax({**state.ema_params, **ms})
        if self.swag_state is not None:
            sw = self.swag_state
            d["swag_state"] = {"n_models": np.asarray(sw.n_models, np.int32),
                               "mean": torch_to_flax(sw.mean),
                               "sq_mean": torch_to_flax(sw.sq_mean)}
            if sw.dev is not None:
                d["swag_state"]["dev"] = torch_to_flax(sw.dev, lead=1)
        return d

    def _save_last(self, state: TrainState, epoch: int) -> None:
        if not is_primary():  # the state is replicated: the primary writes it
            return
        save_checkpoint(self._ckpt_dir() / "last", self.full_state_dict(state), self.cfg,
                        epoch=epoch, kind="full")

    def _save_scheduled(self, state: TrainState, epoch: int) -> None:
        if not is_primary():
            return
        ms = state.model_state or {}
        if self.cfg.ema.only_save_ema and state.ema_params is not None:
            payload, kind = {"ema_params": torch_to_flax({**state.ema_params, **ms})}, "ema_only"
        else:
            payload, kind = {"params": torch_to_flax({**state.params, **ms})}, "weights"
            if state.ema_params is not None:
                payload["ema_params"] = torch_to_flax({**state.ema_params, **ms})
        save_checkpoint(self._ckpt_dir() / f"epoch_{epoch:06d}", payload, self.cfg, epoch=epoch,
                        kind=kind)

    def _log(self, record: dict) -> None:
        if not is_primary():  # every rank's record is the same
            return
        if self._logger is None:
            from ..utils.loggers import MetricLogger

            self._logger = MetricLogger(self.workdir, self.cfg.trainer.loggers)
        self._logger.log(record)
