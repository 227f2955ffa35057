"""The (data, member) layout over ``torch.distributed``
(``diffuncertainty_tpu_torch/parallel/``, the loader's ``process_shard``, the
sharded job, sampler, stitch and data-parallel trainer).

In process: the loader's shard orders and the job's mesh choice against the
JAX package's; ``initialize_distributed``'s no-op and its refusal of a
partial topology. Then one two-rank ``gloo`` world on the CPU
(``tests/torch_parallel_world.py``, spawned once, with a timeout of its own)
runs every sharded path beside its single-process twin on a small DiffUnet
and a small HRNet: the job at (2, 1) and (1, 2) against the one-process job
(trees compared here), three data-parallel steps against single-process
steps on the global batch (JAX's tolerances of ``tests/test_parallel.py``:
loss rtol 1e-4, parameters atol (i + 1) * 2.5e-4) and the sharded
validation of the same weights against the single process's (the step's
loss tolerance, rtol 1e-4, on every logged number), the tile-sharded stitch
(atol 2e-6), the member layout against ``member_chunk``, 4-member
prob-U-Net and HRNet stacks at (1, 2) and (2, 1) against the single
process's stack (the jobs' atol 1e-5), and the writes of each rank."""

import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from diffuncertainty_tpu.data.loader import BatchLoader as JLoader
from diffuncertainty_tpu.infer import runner as j_runner
from diffuncertainty_tpu_torch.data.loader import BatchLoader as TLoader
from diffuncertainty_tpu_torch.data.toy import generate_toy_dataset
from diffuncertainty_tpu_torch.infer.image_io import read_tiff
from diffuncertainty_tpu_torch.infer.runner import _resolve_mesh
from diffuncertainty_tpu_torch.parallel import distributed as t_dist
from diffuncertainty_tpu_torch.train import cli as t_cli
from diffuncertainty_tpu_torch.train.loop import Trainer
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 120
SMALL_NET = ["network.model_channels=8", "network.num_res_blocks=[1,1]",
             "network.channel_mult=[1,2]", "network.attention_resolutions=[-1]"]


class ArrayDataset:
    """index -> a sample whose image holds its index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def load(self, i, rng=None):
        return {"image": np.full((4, 4, 3), float(i), np.float32),
                "seg": np.full((4, 4), i % 2, np.int32), "image_id": f"im{i:03d}",
                "dataset": "test"}


# ------------------------------------------------------------- in process

@pytest.mark.parametrize("n, count", [(21, 4), (8, 2), (5, 3), (3, 3), (1, 2)])
def test_process_shard_orders_equal_jax(n, count):
    for shuffle in (False, True):
        for seed, epoch, drop_last in ((0, 0, False), (3, 1, True), (7, 5, False)):
            for pidx in range(count):
                kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last,
                          process_shard=(pidx, count))
                j = JLoader(ArrayDataset(n), 2, use_native=False, **kw)
                t = TLoader(ArrayDataset(n), 2, **kw)
                j.set_epoch(epoch)
                t.set_epoch(epoch)
                assert len(t) == len(j)
                np.testing.assert_array_equal(t._order(), j._order())
    with pytest.raises(ValueError, match="process_shard"):
        TLoader(ArrayDataset(n), 2, process_shard=(count, count))


def test_resolve_mesh_equals_jax(monkeypatch):
    monkeypatch.setattr(j_runner, "make_mesh", lambda shape, names: tuple(shape))
    shapes = [None, (1, 1), (2, 1), (1, 2), (2, 2), (4, 2), (3, 1), (1, 4)]
    for world in (1, 2, 3, 4, 6, 8):
        monkeypatch.setattr(j_runner.jax, "device_count", lambda w=world: w)
        for batch in (1, 2, 4, 6, 16):
            for stacked in ([], [4], [2, 6], [16], [3]):
                for shape in shapes:
                    try:
                        ref = j_runner._resolve_mesh(shape, batch, stacked)
                    except ValueError as exc:
                        with pytest.raises(ValueError, match=str(exc)[:20]):
                            _resolve_mesh(shape, batch, stacked, world)
                        continue
                    assert _resolve_mesh(shape, batch, stacked, world) == ref, (
                        world, batch, stacked, shape)


def test_initialize_distributed_noop_and_missing_topology(monkeypatch):
    for var in ("DU_COORDINATOR", "DU_NUM_PROCESSES", "DU_PROCESS_ID", "WORLD_SIZE",
                "MASTER_ADDR", "RANK", "DU_DIST_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    assert not torch.distributed.is_initialized()
    assert t_dist.initialize_distributed(device="cpu") is False  # nothing configured
    assert t_dist.process_info() == (0, 1)
    assert t_dist.loader_shard() is None and t_dist.is_primary()
    monkeypatch.setenv("DU_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="DU_NUM_PROCESSES and DU_PROCESS_ID"):
        t_dist.initialize_distributed(device="cpu")
    monkeypatch.setenv("DU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="DU_PROCESS_ID"):
        t_dist.initialize_distributed(device="cpu")
    monkeypatch.setenv("DU_PROCESS_ID", "0")
    monkeypatch.setenv("DU_DIST_BACKEND", "mpi")  # no backend is chosen by itself
    with pytest.raises(ValueError, match="nccl"):
        t_dist.initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------- the two-rank world

def checkpoint(work: Path, name: str, eu: str, seed: int) -> None:
    """A port ``last`` checkpoint of the small softmax DiffUnet, noise on
    every leaf (a zero-initialized head would hide the members' diversity)."""
    cfg, _ = t_cli.parse_args(["data=toy64", "network=unet16", "model=softmax",
                               f"eu_method={eu}", f"data.data_input_dir={work / 'toy'}",
                               "trainer.loggers=[jsonl]", *SMALL_NET, "device=cpu"])
    trainer = Trainer(cfg, workdir=work / name, device="cpu")
    trainer.init_state()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in trainer.built.module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    trainer._save_last(trainer.fresh_state(), 0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' reports (dicts) and the work directory."""
    work = tmp_path_factory.mktemp("world")
    generate_toy_dataset(work / "toy", num_train=8, num_val=4, num_test=8, num_ood=4,
                         num_raters=3, size=32, seed=0)
    checkpoint(work, "ckpt_drop", "dropout", 1)
    for i in range(4):
        checkpoint(work, f"ckpt_ens{i}", "none", 10 + i)
    port = free_port()
    env = {**os.environ, "DU_COORDINATOR": f"localhost:{port}", "DU_NUM_PROCESSES": "2",
           "OMP_NUM_THREADS": "1", "PYTHONPATH": f"{REPO}{os.pathsep}"
           + os.environ.get("PYTHONPATH", "")}
    env.pop("DU_DIST_BACKEND", None)
    procs = []
    for r in range(2):
        with open(work / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "tests" / "torch_parallel_world.py"), str(work)],
                env={**env, "DU_PROCESS_ID": str(r)}, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    for proc in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:  # a hang fails the world's tests, not the suite
            for p in procs:
                p.kill()
                p.wait()
    logs = [(work / f"rank{r}.log").read_text() for r in range(2)]
    reports = [pickle.loads((work / f"rank{r}.pkl").read_bytes())
               if (work / f"rank{r}.pkl").exists() else {} for r in range(2)]
    return {"work": work, "reports": reports, "logs": logs,
            "returncodes": [p.returncode for p in procs]}


def report(world, key):
    """rank 0's value of ``key``; a rank that failed or hung fails the test."""
    for r, rep in enumerate(world["reports"]):
        errors = {k: v for k, v in rep.items() if k.endswith("_error")}
        assert not errors, f"rank {r}: {errors}"
        assert rep.get("done"), (f"rank {r} did not finish in {WORLD_TIMEOUT_S} s (exit "
                                 f"{world['returncodes'][r]}): {world['logs'][r][-3000:]}")
    return world["reports"][0][key]


def assert_same_results(ref: Path, got: Path, atol: float = 1e-5):
    """The same files; metrics, likelihoods and heatmaps to ``atol``; the
    argmax PNGs equal."""
    files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(got) for p in got.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".json":
            a, b = (json.loads((d / rel).read_text()) for d in (ref, got))
            assert list(a) == list(b)
            flat = [np.asarray(v, float) for rec in (a, b) for r in rec.values()
                    for v in (r["metrics"].values() if "metrics" in r
                              else [x for k, x in r.items() if k != "dataset"])]
            half = len(flat) // 2
            for x, y in zip(flat[:half], flat[half:]):
                np.testing.assert_allclose(y, x, atol=atol, err_msg=str(rel))
        elif rel.suffix == ".tif":
            np.testing.assert_allclose(read_tiff(got / rel), read_tiff(ref / rel), atol=atol,
                                       err_msg=str(rel))
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(got / rel)),
                                          np.asarray(Image.open(ref / rel)), err_msg=str(rel))


def test_the_job_at_2_1_equals_the_single_process_job(world):
    assert report(world, "d21_mesh") == {"data": 2, "member": 1}
    assert report(world, "ref_drop_mesh") is None
    assert report(world, "d21_summary")["n_images"] == 8
    assert world["reports"][1]["d21_summary"]["n_images"] == 8
    assert_same_results(world["work"] / "ref_drop", world["work"] / "d21")


def test_the_job_at_1_2_equals_the_single_process_job(world):
    assert report(world, "m12_mesh") == {"data": 1, "member": 2}
    # two of the four members a rank, in one block although member_chunk=1
    assert report(world, "m12_blocks") == [2] and report(world, "ref_ens_blocks") == [4]
    assert_same_results(world["work"] / "ref_ens", world["work"] / "m12")


@pytest.mark.parametrize("net", ["dp_unet", "dp_hrnet"])
def test_a_data_parallel_step_equals_the_single_process_step(world, net):
    rec = report(world, net)
    assert rec == world["reports"][1][net]  # the state stays replicated
    for i, (loss_dp, loss_single, diff) in enumerate(zip(
            rec["loss_dp"], rec["loss_single"], rec["max_param_diff"])):
        assert np.isfinite(loss_single)
        np.testing.assert_allclose(loss_dp, loss_single, rtol=1e-4)
        assert diff <= (i + 1) * 2.5e-4, (i, diff)
    if net == "dp_hrnet":
        # the running statistics of the first step (the same weights on both
        # sides): the global batch's moments, to float32 rounding of the sums
        assert rec["max_stats_rel_diff"][0] <= 1e-5, rec["max_stats_rel_diff"]


@pytest.mark.parametrize("net", ["dp_unet", "dp_hrnet"])
def test_data_parallel_validation_equals_the_single_process_validation(world, net):
    """The same weights validated at (2, 1) and in one process: the batch
    of 4 runs 2 rows a rank, the tail of 3 whole on each; every logged
    number (the multi-rater HRNet batches add ``val_ged``) to the step's
    loss tolerance."""
    rec = report(world, net)
    assert rec["val_dp"] == world["reports"][1][net]["val_dp"]  # every rank logs the same
    assert rec["val_rows_dp"] == [2, 3]
    keys = {"val_loss", "val_dice"} | ({"val_ged"} if net == "dp_hrnet" else set())
    assert set(rec["val_dp"]) == set(rec["val_single"]) == keys
    for k in keys:
        assert np.isfinite(rec["val_single"][k])
        np.testing.assert_allclose(rec["val_dp"][k], rec["val_single"][k], rtol=1e-4, err_msg=k)


def test_the_tile_sharded_stitch_equals_the_unsharded_one(world):
    assert report(world, "stitch_shape") == (1, 40, 56, 2)
    assert report(world, "stitch_max_diff") <= 2e-6


def test_the_member_layout_beats_member_chunk(world):
    assert report(world, "member_mesh_blocks") == [2]
    assert report(world, "member_chunk1_blocks") == [1, 1, 1, 1]
    assert report(world, "member_one_block_blocks") == [4]
    assert report(world, "member_max_diff") <= 1e-6


@pytest.mark.parametrize("family", ["prob_unet", "hrnet"])
def test_an_unfolded_stack_shards_over_either_axis_as_the_single_process_stack(world, family):
    """A 4-member stack with no member-folded form: at (1, 2) each rank runs
    its two members one a block, at (2, 1) its image of all four; both equal
    the single process's stack (the jobs' atol 1e-5), whose members differ."""
    assert report(world, f"{family}_shape") == (4, 2, 2, 32, 32, 2)
    assert report(world, f"{family}_single_blocks") == [1, 1, 1, 1]
    assert report(world, f"{family}_m12_blocks") == [1, 1]
    assert report(world, f"{family}_d21_blocks") == [1, 1, 1, 1]
    for layout in ("m12", "d21"):
        for rep in world["reports"]:
            assert rep[f"{family}_{layout}_max_diff"] <= 1e-5, (layout, rep["rank"])
    assert report(world, f"{family}_member_spread") > 1e-3


def test_only_rank_0_writes(world):
    writes = [rep["writes"] for rep in world["reports"]]
    assert report(world, "fit_steps") == 2  # 8 train images, 2 a rank a step
    assert writes[1] == {"results": 0, "checkpoints": 0}
    assert writes[0]["results"] == 4 and writes[0]["checkpoints"] >= 1
    fit = Path(report(world, "fit_workdir"))
    assert (fit / "checkpoints" / "last").exists()
    assert len((fit / "metrics.jsonl").read_text().splitlines()) == 1
