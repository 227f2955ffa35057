"""Export a checkpoint of the JAX package (orbax) to the PyTorch port's format.

    python export_torch_checkpoint.py SRC DST

Reads ``SRC`` with ``diffuncertainty_tpu.core.checkpoint.load_checkpoint``
and writes ``DST`` with ``diffuncertainty_tpu_torch.core.checkpoint``:
``config.json`` as it was, ``meta.json`` with the same epoch and kind, and
every array of the state in ``arrays.npz`` at its own dtype. Of the
optimizer state (``opt_state``, the state of the JAX trainer's optax chain
``clip_by_global_norm`` then ``adamw``) it keeps the ``ScaleByAdamState``
alone, as ``opt_state/{count, mu, nu}``: the other members of the chain hold
no arrays (the schedule's count equals the Adam count), and this is what the
port's trainer restores with ``resume_from``. An ``opt_state`` without one
is left out. This is the one module of the
repo that imports both packages; it runs wherever JAX runs.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

ADAM_KEYS = {"count", "mu", "nu"}


def adam_state(opt_state) -> dict | None:
    """The one ``ScaleByAdamState`` (a node with exactly the keys count, mu
    and nu, as orbax restores a named tuple) of a restored optax state, or
    None if it has none."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if set(node) == ADAM_KEYS:
                found.append(node)
            else:
                for v in node.values():
                    walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(opt_state)
    if len(found) > 1:
        raise ValueError(f"expected one ScaleByAdamState in opt_state, found {len(found)}")
    return found[0] if found else None


def export(src: str | Path, dst: str | Path) -> Path:
    from diffuncertainty_tpu.core.checkpoint import load_checkpoint
    from diffuncertainty_tpu_torch.core.checkpoint import save_checkpoint

    state, _, meta = load_checkpoint(src)
    had_opt = "opt_state" in state
    adam = adam_state(state.pop("opt_state", None))
    if adam is not None:
        state["opt_state"] = adam
    config = json.loads((Path(src) / "config.json").read_text())
    out = save_checkpoint(dst, state, config, epoch=int(meta["epoch"]),
                          kind=meta.get("kind", "full"))
    print(f"exported {src} -> {out}: {', '.join(sorted(state))}"
          + ("; left out opt_state (no ScaleByAdamState in it)"
             if adam is None and had_opt else ""))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="JAX checkpoint directory")
    parser.add_argument("dst", help="directory to write (replaced if it exists)")
    args = parser.parse_args(argv)
    export(args.src, args.dst)


if __name__ == "__main__":
    main()
