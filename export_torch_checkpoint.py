"""Export a checkpoint of the JAX package (orbax) to the PyTorch port's format.

    python export_torch_checkpoint.py SRC DST

Reads ``SRC`` with ``diffuncertainty_tpu.core.checkpoint.load_checkpoint``
and writes ``DST`` with ``diffuncertainty_tpu_torch.core.checkpoint``:
``config.json`` as it was, ``meta.json`` with the same epoch and kind, and
every array of the state in ``arrays.npz`` at its own dtype. The optimizer
state (``opt_state``), which inference does not read, is left out. This is
the one module of the repo that imports both packages; it runs wherever JAX
runs.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

DROPPED = ("opt_state",)


def export(src: str | Path, dst: str | Path) -> Path:
    from diffuncertainty_tpu.core.checkpoint import load_checkpoint
    from diffuncertainty_tpu_torch.core.checkpoint import save_checkpoint

    state, _, meta = load_checkpoint(src)
    dropped = [k for k in DROPPED if k in state]
    state = {k: v for k, v in state.items() if k not in dropped}
    config = json.loads((Path(src) / "config.json").read_text())
    out = save_checkpoint(dst, state, config, epoch=int(meta["epoch"]),
                          kind=meta.get("kind", "full"))
    print(f"exported {src} -> {out}: {', '.join(sorted(state))}"
          + (f"; left out {', '.join(dropped)} (inference does not read it)" if dropped else ""))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="JAX checkpoint directory")
    parser.add_argument("dst", help="directory to write (replaced if it exists)")
    args = parser.parse_args(argv)
    export(args.src, args.dst)


if __name__ == "__main__":
    main()
