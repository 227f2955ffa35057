"""The process group of a multi-process run (port of
``diffuncertainty_tpu/parallel/distributed.py``).

In JAX one process sees every device of its host and ``jax.distributed``
joins the hosts. The port runs one process per device (SPMD: every rank runs
this same program), so the "device count" of the port is the world size of
the initialized ``torch.distributed`` process group, and 1 when none is
initialized. Each rank's device is ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from
``torchrun``, else the rank modulo the visible cards) unless the caller asks
for the CPU.

- :func:`initialize_distributed` joins the group. It reads
  ``DU_COORDINATOR`` (``host:port`` of rank 0's rendezvous),
  ``DU_NUM_PROCESSES`` and ``DU_PROCESS_ID`` as the JAX module does, with the
  same ``ValueError`` when the topology is missing; in place of the TPU pod
  autodetection it takes ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``,
  ``RANK`` and ``WORLD_SIZE``. A single process with nothing configured is a
  no-op. The backend is explicit: ``nccl`` for one card per rank, ``gloo``
  for the CPU, or what ``backend`` / ``DU_DIST_BACKEND`` names (two ranks on
  one card need ``gloo``: NCCL refuses two ranks on one device). It never
  changes by itself.
- :func:`loader_shard` is the ``BatchLoader(process_shard=...)`` value of
  this rank: its data-axis coordinate and the data axis's size.
- :func:`global_batch` is the batch as the rank's step sees it;
  :func:`is_primary` names the rank that writes checkpoints, logs and
  results.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           *, device: str = "cuda", backend: str | None = None) -> bool:
    """Join this process to the run's process group (idempotent); True when
    more than one process runs. ``device`` ("cuda" or "cpu") picks the
    default backend (``nccl`` or ``gloo``) and, on ``cuda``, the rank's card
    (:func:`local_device`), which is made current."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = coordinator_address or os.environ.get("DU_COORDINATOR")
    if coordinator_address is not None:
        num_processes = num_processes if num_processes is not None else os.environ.get(
            "DU_NUM_PROCESSES")
        process_id = process_id if process_id is not None else os.environ.get("DU_PROCESS_ID")
        missing = [name for name, val in (("DU_NUM_PROCESSES", num_processes),
                                          ("DU_PROCESS_ID", process_id)) if val is None]
        if missing:
            raise ValueError("explicit coordinator rendezvous needs the process topology: "
                             f"set {' and '.join(missing)} (or pass num_processes/process_id)")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    elif os.environ.get("WORLD_SIZE") and os.environ.get("MASTER_ADDR"):  # torchrun
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False  # a single process, nothing to join
    backend = backend or os.environ.get("DU_DIST_BACKEND") or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"DU_DIST_BACKEND / backend must be one of {BACKENDS}, got {backend!r}")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device(device, rank))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
    return world > 1


def local_device(device: str = "cuda", rank: int | None = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (``torchrun`` sets it; else
    the rank modulo the visible cards), or the CPU when ``device`` is "cpu"."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a cuda rank needs a card, and torch.cuda.is_available() is False")
    if rank is None:
        rank = process_info()[0]
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def process_info() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def loader_shard(mesh=None) -> tuple[int, int] | None:
    """The ``BatchLoader(process_shard=...)`` value of this rank: None in a
    single process; else (data coordinate, data axis size) of ``mesh``
    (ranks along the member axis load the same rows), or (rank, world)."""
    if mesh is not None:
        size = mesh.size("data")
        return None if size == 1 else (mesh.coord("data"), size)
    idx, count = process_info()
    return None if count == 1 else (idx, count)


def global_batch(batch: dict, mesh, axis: str = "data") -> dict:
    """The batch this rank's step runs. One process: the rank's rows of the
    global batch (``mesh.shard_batch``). Several: each rank loaded its own
    rows (:func:`loader_shard`), which are its part of the global batch as
    they are."""
    from .mesh import shard_batch

    if process_info()[1] == 1:
        return shard_batch(batch, mesh, axis)
    return batch


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and the results tree."""
    return process_info()[0] == 0
