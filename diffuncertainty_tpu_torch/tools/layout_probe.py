"""Where a seeded HRNet member stack parts between one process and the
member-sharded ranks on the card.

    python3 -m diffuncertainty_tpu_torch.tools.layout_probe [--out FILE]

The stack of ``chip_smoke.py``'s multidevice path: four bf16 hrnet-s members
(each its own seeded init), 16 inputs at 128x128, ``n_pred`` 4 with TTA,
one seed. In order:

1. the single process (``member_chunk=None``) twice: determinism;
2. ``member_chunk=1`` in the same process against it;
3. two gloo ranks at mesh (1, 2) (this module with ``--rank``), each
   recording every TTA matrix, dropout mask and logit tensor of its two
   members, and the same members' records of a single-process stack in the
   rank's own process, through the same generators (``ShardedGenerator``);
   once with the rank processes' float32 flags as torch starts them and
   once with cuDNN's and the matmuls' TF32 switched off, as ``chip_smoke.py``
   switches them off in its own process;
4. the parent's stack with cuDNN's TF32 on and off;
5. two gloo ranks at (2, 1), TF32 off everywhere: each rank's eight images
   of all four members against the same rows run without the mesh through
   the ``ShardedGenerator`` the mesh gives them (in the rank and here), and
   the gathered stack against the 16-image call;
6. one member's forward on 32 rows alone against the same rows at the head
   of a 64-row batch (the numerics of a convolution by its batch).

Prints one JSON line: for each comparison the largest |difference| of the
stack (or of each record kind) and the argmax agreement of the mean.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

MEMBERS = 4
IMAGES = 16
HW = 128
N_PRED = 4
SEED = 777


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def build():
    """(built hrnet-s bf16 model on the card, its four-member stack, the
    inputs, the TTA config of its data config)."""
    from ..core.config import load_config
    from ..core.params import stack_states
    from ..infer.runner import _tta_config
    from ..models.factory import build_model
    from ..models.unet import flax_init_

    cfg = load_config(data="lidc128", network="hrnet-s", model="softmax",
                      eu_method="ensemble", precision="bf16")
    cpu = build_model(cfg, device="cpu").module
    states = []
    for i in range(MEMBERS):
        flax_init_(cpu, torch.Generator().manual_seed(300 + i))
        states.append({k: v.float().clone() for k, v in cpu.state_dict().items()})
    built = build_model(cfg, device="cuda")
    stack = {k: v.cuda() for k, v in stack_states(states, built.module).items()}
    x = np.random.default_rng(0).standard_normal((IMAGES, HW, HW, 3)).astype(np.float32)
    return built, stack, torch.from_numpy(x).cuda(), _tta_config(cfg.data.augmentations)


class Recorder:
    """Records each TTA draw, dropout mask and logits tensor, in call order."""

    def __init__(self, built):
        from ..models import hrnet as hrnet_mod
        from ..models import unet as unet_mod
        from ..sampling import sampler as sampler_mod

        self.records: list[tuple[str, torch.Tensor]] = []
        self.on = False
        tta, mask, keep = (sampler_mod.sample_tta_params, unet_mod.ChannelDropout.draw_mask,
                           hrnet_mod.HRNet.draw_keep)

        def record(kind, t):
            if self.on:
                self.records.append((kind, t.detach().float().cpu().clone()))
            return t

        def tta_params(*a, **k):
            p = tta(*a, **k)
            record("tta", p.forward)
            return p

        sampler_mod.sample_tta_params = tta_params
        unet_mod.ChannelDropout.draw_mask = lambda s, *a, **k: record("mask", mask(s, *a, **k))
        hrnet_mod.HRNet.draw_keep = lambda s, *a, **k: record("keep", keep(s, *a, **k))

        def logits(module, args, out):
            record("logits", out.logits)  # returns None: the output stays

        built.module.register_forward_hook(logits)

    def run(self, fn):
        self.records, self.on = [], True
        try:
            out = fn()
        finally:
            self.on = False
        return out, self.records


def sampler_for(built, stack, tta_config, chunk="auto", mesh=None):
    from ..sampling.sampler import SamplerSpec, make_sampler

    spec = SamplerSpec(n_pred=N_PRED, n_members=MEMBERS, member_mode="params_stack", tta=True,
                       tta_config=tta_config, member_chunk=chunk)
    return make_sampler(built, spec, members=stack, mesh=mesh)


def generator():
    return torch.Generator("cuda").manual_seed(SEED)


def compare_records(a: list, b: list) -> dict:
    """The largest |difference| per record kind of two equal-length lists."""
    if [k for k, _ in a] != [k for k, _ in b]:
        return {"kinds_differ": True, "n": [len(a), len(b)]}
    out: dict = {}
    for (kind, x), (_, y) in zip(a, b):
        out[kind] = max(out.get(kind, 0.0), float((x - y).abs().max()))
    return out


def stack_diff(a, b) -> dict:
    return {"max_abs": float((a.groups.float() - b.groups.float()).abs().max()),
            "mean_abs_mean": float((a.mean.float() - b.mean.float()).abs().mean()),
            "argmax_agreement": float((a.mean.argmax(-1) == b.mean.argmax(-1)).float().mean())}


def rank_main(work: Path) -> None:
    """One rank. At (1, 2): its two members, and the same members of the
    single-process stack run in this process. At (2, 1): its eight images of
    all four members, and the same rows run in this process without the
    mesh through the ``ShardedGenerator`` the mesh gives them. Records and
    stacks saved."""
    from ..parallel.distributed import initialize_distributed, process_info
    from ..parallel.mesh import ShardedGenerator, make_mesh

    if os.environ.get("PROBE_TF32_OFF") == "1":
        set_tf32(False)
    shape = tuple(int(c) for c in os.environ["PROBE_MESH"])
    initialize_distributed(device="cuda")
    rank, _ = process_info()
    built, stack, x, tta_cfg = build()
    rec = Recorder(built)
    mesh = make_mesh(shape)
    sharded, got = rec.run(lambda: sampler_for(built, stack, tta_cfg, 1, mesh)(x, generator()))
    if shape == (1, 2):
        _, ref = rec.run(lambda: sampler_for(built, stack, tta_cfg, None)(x, generator()))
        per = len(ref) // MEMBERS
        ref = ref[2 * rank * per:2 * (rank + 1) * per]
    else:
        rows = mesh.rows(x.shape[0], "data")
        _, ref = rec.run(lambda: sampler_for(built, stack, tta_cfg, None)(
            x[rows], ShardedGenerator(generator(), x[rows].shape[0], (rank, 2))))
    torch.save({"rank": rank, "records": got, "single_records": ref,
                "stack": sharded.groups.float().cpu(),
                "flags": [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]},
               work / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def world(work: Path, tf32_off: bool, mesh: str = "12") -> list[dict]:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "DU_COORDINATOR": f"localhost:{port}", "DU_NUM_PROCESSES": "2",
           "DU_DIST_BACKEND": "gloo", "PROBE_TF32_OFF": "1" if tf32_off else "0",
           "PROBE_MESH": mesh}
    procs = [subprocess.Popen([sys.executable, "-m", "diffuncertainty_tpu_torch.tools.layout_probe",
                               "--rank", str(work)], env={**env, "DU_PROCESS_ID": str(r)})
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError(f"a rank failed: {[p.returncode for p in procs]}")
    return [torch.load(work / f"rank{r}.pt") for r in range(2)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help="write the JSON there too")
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(Path(args.rank))
        return 0
    if not torch.cuda.is_available():
        print("layout_probe: no CUDA device", file=sys.stderr)
        return 1
    from ..parallel.mesh import ShardedGenerator

    t0 = time.perf_counter()
    set_tf32(False)  # as chip_smoke.py's own process
    built, stack, x, tta_cfg = build()
    rec = Recorder(built)
    ref, ref_records = rec.run(lambda: sampler_for(built, stack, tta_cfg, None)(x, generator()))
    again = sampler_for(built, stack, tta_cfg, None)(x, generator())
    chunk1 = sampler_for(built, stack, tta_cfg, 1)(x, generator())
    set_tf32(True)
    tf32, tf32_records = rec.run(
        lambda: sampler_for(built, stack, tta_cfg, None)(x, generator()))
    set_tf32(False)
    per = len(ref_records) // MEMBERS
    out = {"device": torch.cuda.get_device_name(0),
           "blocks": sampler_for(built, stack, tta_cfg, None).blocks,
           "records_per_member": {k: sum(1 for r, _ in ref_records[:per] if r == k)
                                  for k in ("tta", "mask", "keep", "logits")},
           "1_twice": stack_diff(ref, again), "2_chunk1": stack_diff(ref, chunk1),
           "4_tf32_on_vs_off": {**stack_diff(ref, tf32),
                                "records": compare_records(ref_records, tf32_records)}}
    with tempfile.TemporaryDirectory() as tmp:
        for label, off in (("3_ranks_default_flags", False), ("3_ranks_tf32_off", True)):
            reps = world(Path(tmp), off)
            res = {"rank_flags": reps[0]["flags"]}
            for rep in reps:
                r = rep["rank"]
                mine = ref_records[2 * r * per:2 * (r + 1) * per]
                theirs = tf32_records[2 * r * per:2 * (r + 1) * per]
                res[f"rank{r}"] = {
                    "rank_vs_own_process": compare_records(rep["records"], rep["single_records"]),
                    "rank_vs_parent_tf32_off": compare_records(rep["records"], mine),
                    "rank_vs_parent_tf32_on": compare_records(rep["records"], theirs)}
            got = reps[0]["stack"]  # gathered over the member axis
            res["stack_vs_parent_tf32_off_max_abs"] = float((got - ref.groups.float().cpu())
                                                            .abs().max())
            res["stack_vs_parent_tf32_on_max_abs"] = float((got - tf32.groups.float().cpu())
                                                           .abs().max())
            out[label] = res
        # 5. at (2, 1), TF32 off everywhere: each rank's rows through the
        # same ShardedGenerator in its own process and in this one, against
        # the gathered stack and the whole batch's call
        reps = world(Path(tmp), True, "21")
        half = x.shape[0] // 2
        halves = [sampler_for(built, stack, tta_cfg, None)(
            x[d * half:(d + 1) * half], ShardedGenerator(generator(), half, (d, 2)))
            for d in range(2)]
        got = reps[0]["stack"]  # gathered over the data axis (dim 2)
        emulated = torch.cat([h.groups.float().cpu() for h in halves], dim=2)
        mean = got.mean(dim=1).mean(dim=0)  # as the sampler's finalize
        out["5_ranks_21"] = {
            "rank_vs_own_process": [compare_records(rep["records"], rep["single_records"])
                                    for rep in reps],
            "stack_vs_rows_in_this_process_max_abs": float((got - emulated).abs().max()),
            "stack_vs_whole_batch": {
                "max_abs": float((got - ref.groups.float().cpu()).abs().max()),
                "mean_abs_mean": float((mean - ref.mean.float().cpu()).abs().mean()),
                "argmax_agreement": float((mean.argmax(-1) == ref.mean.float().cpu().argmax(-1))
                                          .float().mean())}}
    # 6. one member's forward: rows alone against the same rows in a batch twice as large
    member = {k: v[0] for k, v in stack.items()}
    rows = torch.cat([x] * (N_PRED // 2))
    with torch.no_grad():
        full = torch.func.functional_call(built.module, member, (torch.cat([rows, rows]),))
        part = torch.func.functional_call(built.module, member, (rows,))
    out["6_batch_rows"] = {"rows": [2 * rows.shape[0], rows.shape[0]],
                           "max_abs_logits": float(full.logits.float().abs().max()),
                           "logits_max_abs_diff": float((full.logits[:rows.shape[0]].float()
                                                         - part.logits.float()).abs().max())}
    out["seconds"] = round(time.perf_counter() - t0, 1)
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
