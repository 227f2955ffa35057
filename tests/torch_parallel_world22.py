"""One rank of the four-rank CPU world of ``tests/test_torch_port_parallel22.py``:
the (data, member) layout at (2, 2).

    DU_COORDINATOR=localhost:PORT DU_NUM_PROCESSES=4 DU_PROCESS_ID=R \\
        python tests/torch_parallel_world22.py WORKDIR

``WORKDIR`` holds the toy dataset (``toy/``) and four port checkpoints of
the small DiffUnet (``ckpt_ens<i>``). Each rank runs the inference job over
the four-member ensemble (TTA, two rounds a member) at (2, 2) after the
single-process job, and a four-member HRNet stack (stage and final
dropout, TTA) at (2, 2) beside the single process's stack of the same
seed; it writes ``rank<R>.pkl``.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

from diffuncertainty_tpu_torch.infer import runner as runner_lib
from diffuncertainty_tpu_torch.infer.runner import InferenceConfig, UncertaintyInference
from diffuncertainty_tpu_torch.models.factory import build_model
from diffuncertainty_tpu_torch.models.hrnet import HRNet, HRNetSpec
from diffuncertainty_tpu_torch.parallel.distributed import initialize_distributed, process_info
from diffuncertainty_tpu_torch.parallel.mesh import make_mesh
from diffuncertainty_tpu_torch.sampling.sampler import PredictionStack, SamplerSpec, make_sampler
from torch_parallel_world import HRNET_SMALL, load_cfg, member_copies

GLOBAL_BATCH = 4


def jobs(work: Path, out: dict) -> None:
    ckpts = [work / f"ckpt_ens{i}" / "checkpoints" / "last" for i in range(4)]
    base = dict(n_pred=2, tta=True, batch_size=GLOBAL_BATCH, seed=5, device="cpu",
                data_input_dir=str(work / "toy"))
    for name, kw in (("ref", dict(mesh_shape=(1, 1), member_chunk=None)),
                     ("dm22", dict(mesh_shape=(2, 2), member_chunk=1))):
        job = UncertaintyInference(ckpts, InferenceConfig(**base, **kw, save_dir=str(work / name)))
        out[f"{name}_blocks"] = job.sampler.blocks
        out[f"{name}_mesh"] = None if job.mesh is None else dict(job.mesh.shape)
        out[f"{name}_summary"] = job.run_split("id")


def hrnet_stack(out: dict) -> None:
    images = torch.from_numpy(np.random.default_rng(2).random((2, 32, 32, 3), dtype=np.float32))
    built = dataclasses.replace(build_model(load_cfg("hrnet-s", "dropout"), "cpu"),
                                module=HRNet(2, HRNetSpec(**HRNET_SMALL)))
    stack = member_copies(built, 4, 21)
    results = {}
    for layout, mesh in (("single", None), ("dm22", make_mesh((2, 2)))):
        sampler = make_sampler(built, SamplerSpec(n_pred=2, n_members=4, tta=True,
                                                  member_mode="params_stack"),
                               members=stack, mesh=mesh)
        results[layout] = sampler(images, torch.Generator().manual_seed(9))
        out[f"hrnet_{layout}_blocks"] = sampler.blocks
    ref = results["single"]
    out["hrnet_shape"] = tuple(ref.groups.shape)
    out["hrnet_dm22_max_diff"] = max(float((getattr(results["dm22"], k) - getattr(ref, k))
                                           .abs().max()) for k in PredictionStack._fields)
    out["hrnet_member_spread"] = min(float((ref.groups[m] - ref.groups[0]).abs().max())
                                     for m in range(1, 4))


def main(work: Path) -> None:
    torch.set_num_threads(1)
    initialize_distributed(device="cpu")
    rank, world = process_info()
    out: dict = {"rank": rank, "world": world}
    writes = {"results": 0}

    class CountingWriter(runner_lib.ResultsWriter):
        def __init__(self, *a, **k):
            writes["results"] += 1
            super().__init__(*a, **k)

    runner_lib.ResultsWriter = CountingWriter
    for name, check in (("jobs", lambda: jobs(work, out)), ("hrnet", lambda: hrnet_stack(out))):
        try:
            check()
        except Exception:  # noqa: BLE001 - reported to the test, which fails on it
            out[f"{name}_error"] = traceback.format_exc()
        out["writes"] = dict(writes)
        (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
        if f"{name}_error" in out:
            break
    out["done"] = True
    (work / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
