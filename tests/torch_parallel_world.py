"""One rank of the two-rank CPU world of ``tests/test_torch_port_parallel.py``.

    DU_COORDINATOR=localhost:PORT DU_NUM_PROCESSES=2 DU_PROCESS_ID=R \\
        python tests/torch_parallel_world.py WORKDIR

``WORKDIR`` holds what the test prepared (``toy/``, the toy dataset, and
``ckpt_*``, port checkpoints). Each rank joins the world through
``initialize_distributed`` (gloo on the CPU), runs every layout check next
to its single-process twin, and writes ``rank<R>.pkl``: the trees the jobs
wrote are compared by the test; the rest are numbers (differences, block
layouts, counts of writes).
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from diffuncertainty_tpu_torch.core.config import apply_overrides
from diffuncertainty_tpu_torch.core.checkpoint import load_checkpoint
from diffuncertainty_tpu_torch.core.params import flax_to_torch, stack_states
from diffuncertainty_tpu_torch.infer import runner as runner_lib
from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference
from diffuncertainty_tpu_torch.infer.sliding_window import sliding_window_predict
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models.hrnet import HRNet, HRNetSpec
from diffuncertainty_tpu_torch.models.unet import flax_init_
from diffuncertainty_tpu_torch.parallel.distributed import initialize_distributed, process_info
from diffuncertainty_tpu_torch.parallel.mesh import make_mesh
from diffuncertainty_tpu_torch.sampling.sampler import PredictionStack
from diffuncertainty_tpu_torch.sampling.sampler import SamplerSpec, make_sampler
from diffuncertainty_tpu_torch.train import cli as train_cli
from diffuncertainty_tpu_torch.train import loop as loop_lib
from diffuncertainty_tpu_torch.train.loop import Trainer

HRNET_SMALL = dict(width=8, stage1_channels=8, num_modules=(1, 1, 1), num_blocks=1,
                   stage_dropout=(0.1, 0.2, 0.3, 0.4), final_dropout=0.2)
GLOBAL_BATCH = 4
STEPS = 3


def jobs(work: Path, out: dict) -> None:
    """The job at (2, 1) (MC dropout + TTA) and at (1, 2) (a 4-checkpoint
    ensemble, ``member_chunk=1``), each beside its single-process twin."""
    drop = [work / "ckpt_drop" / "checkpoints" / "last"]
    ens = [work / f"ckpt_ens{i}" / "checkpoints" / "last" for i in range(4)]
    base = dict(n_pred=2, n_models=2, tta=True, batch_size=GLOBAL_BATCH, seed=5, device="cpu",
                data_input_dir=str(work / "toy"))
    runs = {"ref_drop": (drop, dict(mesh_shape=(1, 1))),
            "d21": (drop, dict(mesh_shape=(2, 1))),
            "ref_ens": (ens, dict(mesh_shape=(1, 1), member_chunk=None)),
            "m12": (ens, dict(mesh_shape=(1, 2), member_chunk=1))}
    for name, (ckpts, kw) in runs.items():
        job = UncertaintyInference(ckpts, InferenceConfig(**base, **kw,
                                                          save_dir=str(work / name)))
        out[f"{name}_blocks"] = job.sampler.blocks
        out[f"{name}_mesh"] = None if job.mesh is None else dict(job.mesh.shape)
        out[f"{name}_summary"] = job.run_split("id")


def perturbed_(trainer: Trainer, seed: int) -> None:
    """Noise on every parameter (from a seeded CPU generator, the same on
    every rank and in both trainers)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in trainer.built.module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g, dtype=p.dtype).to(p.device))


def batches(seed: int, raters: int | None = None, sizes=(GLOBAL_BATCH,) * STEPS) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        shape = (n, 32, 32) if raters is None else (n, raters, 32, 32)
        seg = (rng.random(shape) < 0.3).astype(np.int32)
        seg[rng.random(shape) < 0.1] = -1  # ignored pixels: a count-normalized loss
        out.append({"image": rng.random((n, 32, 32, 3), dtype=np.float32), "seg": seg})
    return out


def validation(trainers: dict, states: dict, raters, record: dict) -> None:
    """Both trainers' validation of the same weights on a batch that splits
    over the data axis and a tail of 3 that does not (its last row padding):
    the numbers of each and the rows each sharded loss saw."""
    val = batches(5, raters, sizes=(GLOBAL_BATCH, 3))
    val[0]["valid"] = np.ones(GLOBAL_BATCH, bool)
    val[1]["valid"] = np.array([True, True, False])
    rows = record["val_rows_dp"] = []
    fns = trainers["dp"]._eval_loss_fns
    for group, fn in list(fns.items()):
        fns[group] = lambda module, batch, *a, _f=fn: rows.append(len(batch["image"])) or _f(
            module, batch, *a)
    for kind in ("dp", "single"):
        record[f"val_{kind}"] = trainers[kind].evaluate(states[kind], val, epoch=0)


def dp_steps(cfg, work: Path, name: str, module_fn=None, raters=None) -> dict:
    """``STEPS`` steps of a (2, 1) data-parallel trainer on this rank's rows
    and of a single-process trainer on the whole batch: the loss of each and
    the largest parameter difference after each step."""
    mesh = make_mesh((2, 1))
    rows = mesh.rows(GLOBAL_BATCH, "data")
    states, trainers = {}, {}
    for kind, shape in (("dp", "[2,1]"), ("single", "[1,1]")):
        c = apply_overrides(cfg, [f"trainer.mesh_shape={shape}"])
        built = build_model(c, "cpu")
        if module_fn is not None:
            built = dataclasses.replace(built, module=module_fn())
        trainers[kind] = Trainer(c, workdir=work / f"{name}_{kind}", device="cpu", built=built)
        trainers[kind].init_state()
        perturbed_(trainers[kind], 11)
        states[kind] = trainers[kind].fresh_state()
    record = {"loss_dp": [], "loss_single": [], "max_param_diff": []}
    validation(trainers, states, raters, record)
    gens = {k: trainers[k].epoch_generator(0) for k in trainers}
    for batch in batches(3, raters):
        for kind in ("dp", "single"):
            part = {k: v[rows] for k, v in batch.items()} if kind == "dp" else batch
            states[kind], aux = trainers[kind].train_step(states[kind], part, gens[kind])
            record[f"loss_{kind}"].append(float(aux["loss"]))
        record["max_param_diff"].append(max(
            float((states["dp"].params[k] - states["single"].params[k]).abs().max())
            for k in states["single"].params))
        if states["single"].model_state is not None:  # relative to max(1, |single|)
            record.setdefault("max_stats_rel_diff", []).append(max(
                float(((states["dp"].model_state[k] - states["single"].model_state[k]).abs()
                       / states["single"].model_state[k].abs().clamp(min=1.0)).max())
                for k in states["single"].model_state))
    return record


def stitch(out: dict) -> None:
    """The tile-sharded sliding window against the unsharded stitch: window
    16, stride 12 on 40x56, 15 tiles over 2 ranks (one padding tile)."""
    built = build_model(load_cfg(eu="none"), "cpu")
    flax_init_(built.module, torch.Generator().manual_seed(0))  # the same on every rank
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in built.module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    x = torch.from_numpy(np.random.default_rng(4).random((1, 40, 56, 3), dtype=np.float32))

    def apply_fn(tiles):
        return torch.softmax(built.module(tiles, None).logits, dim=-1)

    with torch.no_grad():
        ref = sliding_window_predict(apply_fn, x, window=16, stride=12)
        got = sliding_window_predict(apply_fn, x, window=16, stride=12, mesh=make_mesh((2, 1)))
    out["stitch_shape"] = tuple(got.shape)
    out["stitch_max_diff"] = float((got - ref).abs().max())


def member_layout(work: Path, out: dict) -> None:
    """At (1, 2) the sampler runs each rank's two members in one block
    whatever ``member_chunk`` says, and its stack equals the unsharded
    one-block stack; without the mesh the chunk holds."""
    states = [load_checkpoint(work / f"ckpt_ens{i}" / "checkpoints" / "last")
              for i in range(4)]
    cfg = states[0][1]
    built = build_model(cfg, "cpu")
    stack = stack_states([flax_to_torch(s["params"]) for s, _, _ in states], built.module)
    images = torch.from_numpy(np.random.default_rng(1).random((2, 32, 32, 3), dtype=np.float32))
    results = {}
    for name, chunk, mesh in (("mesh", 1, make_mesh((1, 2))), ("one_block", None, None),
                              ("chunk1", 1, None)):
        sampler = make_sampler(built, SamplerSpec(n_pred=2, n_members=4, tta=True,
                                                  member_mode="params_stack",
                                                  member_chunk=chunk), members=stack, mesh=mesh)
        results[name] = sampler(images, torch.Generator().manual_seed(9))
        out[f"member_{name}_blocks"] = sampler.blocks
    out["member_max_diff"] = float((results["mesh"].groups
                                    - results["one_block"].groups).abs().max())


def member_copies(built, members: int, seed: int) -> dict:
    """``members`` copies of the module's seeded init, stacked, each with
    its own noise on every float leaf (running variances scaled, so they
    stay positive; the init's zero convs would hide the members)."""
    g = torch.Generator().manual_seed(seed)
    flax_init_(built.module, g)
    states = []
    for _ in range(members):
        state = {}
        for k, v in built.module.state_dict().items():
            z = torch.randn(v.shape, generator=g) if v.is_floating_point() else None
            state[k] = (v.clone() if z is None else v * (1 + 0.2 * z.abs())
                        if k.endswith("running_var") else v + 0.05 * z)
        states.append(state)
    return stack_states(states, built.module)


def unfolded_stacks(out: dict) -> None:
    """4-member stacks of the families with no member-folded form (the
    prob-U-Net, the HRNet with stage and final dropout and TTA) at (1, 2)
    and (2, 1), each beside the single process's stack of the same seed."""
    images = torch.from_numpy(np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32))
    hrnet = build_model(load_cfg("hrnet-s", "dropout"), "cpu")
    models = {"prob_unet": build_model(load_cfg("unet16", "none", model="prob_unet"), "cpu"),
              "hrnet": dataclasses.replace(hrnet, module=HRNet(2, HRNetSpec(**HRNET_SMALL)))}
    for name, built in models.items():
        stack = member_copies(built, 4, 21)
        results = {}
        for layout, mesh in (("single", None), ("m12", make_mesh((1, 2))),
                             ("d21", make_mesh((2, 1)))):
            sampler = make_sampler(built, SamplerSpec(n_pred=2, n_members=4, tta=True,
                                                      member_mode="params_stack"),
                                   members=stack, mesh=mesh)
            results[layout] = sampler(images, torch.Generator().manual_seed(9))
            out[f"{name}_{layout}_blocks"] = sampler.blocks
        ref = results["single"]
        out[f"{name}_shape"] = tuple(ref.groups.shape)
        for layout in ("m12", "d21"):
            out[f"{name}_{layout}_max_diff"] = max(
                float((getattr(results[layout], k) - getattr(ref, k)).abs().max())
                for k in PredictionStack._fields)
        out[f"{name}_member_spread"] = min(float((ref.groups[m] - ref.groups[0]).abs().max())
                                           for m in range(1, 4))


def dp_fit(work: Path, out: dict) -> None:
    """One epoch of the training command at (2, 1): each rank its shard."""
    argv = [f"data.data_input_dir={work / 'toy'}", f"save_dir={work / 'fit'}",
            "data=toy64", "network=unet16", "model=softmax", "eu_method=dropout",
            "trainer.mesh_shape=[2,1]", "trainer.max_epochs=1", "data.batch_size=2",
            "data.val_batch_size=4", "trainer.loggers=[jsonl]", "device=cpu", *SMALL_NET]
    trainer = train_cli.main(argv)
    out["fit_steps"] = len(trainer.step_seconds)
    out["fit_workdir"] = str(trainer.workdir)


SMALL_NET = ["network.model_channels=8", "network.num_res_blocks=[1,1]",
             "network.channel_mult=[1,2]", "network.attention_resolutions=[-1]"]


def load_cfg(network: str = "unet16", eu: str = "dropout", *extra, model: str = "softmax"):
    small = SMALL_NET if network == "unet16" else []
    cfg, _ = train_cli.parse_args([f"network={network}", "data=toy64", f"model={model}",
                                   f"eu_method={eu}", *small, *extra, "device=cpu"])
    return cfg


def main(work: Path) -> None:
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    rank, world = process_info()
    out: dict = {"rank": rank, "world": world}
    writes = {"results": 0, "checkpoints": 0}

    class CountingWriter(runner_lib.ResultsWriter):
        def __init__(self, *a, **k):
            writes["results"] += 1
            super().__init__(*a, **k)

    save = loop_lib.save_checkpoint

    def counting_save(*a, **k):
        writes["checkpoints"] += 1
        return save(*a, **k)

    runner_lib.ResultsWriter = CountingWriter
    loop_lib.save_checkpoint = counting_save
    for name, check in (("jobs", lambda: jobs(work, out)),
                        ("dp_unet", lambda: out.update(dp_unet=dp_steps(load_cfg(), work, "u"))),
                        ("dp_hrnet", lambda: out.update(dp_hrnet=dp_steps(
                            load_cfg("hrnet-s", "dropout"),
                            work, "h", lambda: HRNet(2, HRNetSpec(**HRNET_SMALL)), raters=3))),
                        ("stitch", lambda: stitch(out)),
                        ("member", lambda: member_layout(work, out)),
                        ("unfolded", lambda: unfolded_stacks(out)),
                        ("fit", lambda: dp_fit(work, out))):
        try:
            check()
        except Exception:  # noqa: BLE001 - reported to the test, which fails on it
            out[f"{name}_error"] = traceback.format_exc()
        out["writes"] = dict(writes)
        # after every check: a rank left waiting in a collective still reports
        (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
        if f"{name}_error" in out:
            break
    out["done"] = True
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
