"""Results report command line (port of ``diffuncertainty_tpu/tools/report.py``):
walk evaluated result dirs -> table / LaTeX / a bar chart's series.

    python -m diffuncertainty_tpu_torch.tools.report results_root/**/id \
        --latex table.tex --barplot aurc:failure_detection:aurc.png

Versions are named from their path (exp/version/epoch tags); seed suffixes
``_s<k>`` group automatically (the reference's ``DsTaskTable`` seed
grouping). ``--barplot``'s chart is written as JSON next to the path given,
with ``.json`` in place of its suffix (``evaln/visualization.py``).
"""

from __future__ import annotations

import argparse
import glob
from pathlib import Path

import numpy as np

from ..evaln.visualization import Table, barplot, collect_results, task_table, to_latex


def discover_versions(patterns: list[str]) -> dict[str, Path]:
    versions: dict[str, Path] = {}
    for pat in patterns:
        matches = sorted(glob.glob(pat)) if any(c in pat for c in "*?[") else [pat]
        for m in matches:
            p = Path(m)
            if not (p / "metrics.json").exists():
                continue
            # name: <exp>/test_resultsN/<version>/<epoch> tail, compact and
            # unique per experiment
            name = "/".join(p.parts[-5:-1]) if len(p.parts) >= 5 else str(p)
            versions[name] = p
    return versions


def format_table(table: Table, digits: int = 4) -> str:
    """The table's rows as aligned text, values rounded (NaN as ``NaN``)."""
    head = [" ".join(table.index_names)] + ["/".join(map(str, c)) if isinstance(c, tuple)
                                            else str(c) for c in table.columns]
    body = [[" ".join(map(str, key))] + [str(round(float(v), digits)) if np.isfinite(v)
                                          else "NaN" for v in row]
            for key, row in zip(table.index, table.values)]
    widths = [max(len(r[j]) for r in [head] + body) for j in range(len(head))]
    return "\n".join("  ".join(c.ljust(w) if j == 0 else c.rjust(w)
                               for j, (c, w) in enumerate(zip(r, widths)))
                     for r in [head] + body)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Aggregate evaluated results")
    ap.add_argument("dirs", nargs="+", help="result split dirs (glob ok)")
    ap.add_argument("--latex", default=None, help="write LaTeX table here")
    ap.add_argument("--barplot", default=None,
                    help="metric:task:out.png (e.g. aurc:failure_detection:a.png); the "
                         "series go to out.json")
    ap.add_argument("--no-seed-grouping", action="store_true")
    args = ap.parse_args(argv)

    versions = discover_versions(args.dirs)
    if not versions:
        raise SystemExit("no evaluated result dirs found (need metrics.json)")
    print(f"collected {len(versions)} versions: {', '.join(sorted(versions))}")
    rows = collect_results(versions)
    table = task_table(rows, group_seeds=not args.no_seed_grouping)
    print(format_table(table))
    if args.latex:
        Path(args.latex).write_text(to_latex(table))
        print(f"wrote {args.latex}")
    if args.barplot:
        metric, task, out = args.barplot.split(":", 2)
        print(f"wrote {barplot(rows, metric=metric, task=task, out_path=out)}")
    return table


if __name__ == "__main__":
    main()
