"""The port's ValUES study (``diffuncertainty_tpu_torch/tools/values_study.py``)
end to end on the CPU, and its guards.

One miniature study runs through the command line a user calls, ``python -m
diffuncertainty_tpu_torch.tools.values_study WORKDIR --device cpu``: AU
types softmax and ssn (the triptych needs two) x EU methods none and
dropout x seed 0, one epoch on a 16-px toy of 8 training images, both
shifts and the AL arm; the trainer logs to JSONL only. Its
training, inference and evaluation are the port's own, held to the JAX
package by the other port tests; the report's parts are held to the JAX
package by ``test_torch_port_report.py``. Here: the artifact set, finite
checks, the figures' JSON and PNG, a second run that reuses every cell,
the command line's flags against the JAX ``main``'s, the workdir mismatch,
the AL arm's ensemble rejection and the unreadable ``meta.json`` (it raises
and leaves the cell as it was, where the JAX study deletes it).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import diffuncertainty_tpu_torch.tools.values_study as t_study
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
MINI = ["--au_types", "softmax", "ssn", "--eu_methods", "none", "dropout", "--seeds", "0",
        "--epochs", "1", "--image_size", "16", "--num_train", "8", "--num_val", "4",
        "--num_test", "4", "--num_unlabeled", "4", "--batch_size", "4", "--n_pred", "2",
        "--n_models", "2", "--loggers", "jsonl", "--device", "cpu"]


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    work = tmp_path_factory.mktemp("study") / "work"
    # one thread: the 16-px study's ops are too small to share
    out = subprocess.run([sys.executable, "-m", "diffuncertainty_tpu_torch.tools.values_study",
                          str(work), *MINI], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    assert "skipped" not in out.stdout, out.stdout  # every figure was written
    return work, json.loads((work / "report" / "summary.json").read_text()), out.stdout


def test_miniature_study_writes_the_report(study):
    work, summary, stdout = study
    report = work / "report"
    assert sorted(p.name for p in report.iterdir()) == [
        "REPORT.md", "al_improvement.json", "au_eu_scatter.json", "ds_task_ranks.csv",
        "ds_task_table.csv", "ds_task_table.tex", "ood_auroc_ood_blur.json",
        "ood_auroc_ood_noise.json", "reliability_id.json", "risk_coverage_id.json",
        "summary.json", "task_matrix_overview.json", "uncertainty_triptych.png"]
    assert f"study complete in {summary['wall_seconds']}s" in stdout
    assert summary["matrix"]["versions"] == 4
    assert all(not s["missing"] and s["finished"] for s in summary["preflight"].values())
    checks = summary["checks"]
    for shift in checks["ood_auroc"]["per_shift"].values():
        assert np.isfinite(shift["softmax_entropy_baseline"]) and np.isfinite(shift["best_eu"])
    assert set(checks["ambiguity_ncc"]["mean_au_ncc_by_au_type"]) == {"softmax", "ssn"}
    assert all(np.isfinite(v) for v in checks["ambiguity_ncc"]["mean_au_ncc_by_au_type"].values())
    assert checks["al_improvement"]["computed_both_directions"]
    assert summary["environment"]["device"] == "cpu" and "backend" not in summary["environment"]
    walls = summary["walls"]
    assert set(walls["cells"]) == {f"{m}_s0" for m in ("softmax_none", "softmax_dropout",
                                                       "ssn_none", "ssn_dropout")}
    assert all(set(w) == {"train_s", "infer_s", "evaluate_s"} for w in walls["cells"].values())
    figures = summary["artifacts"]["figures"]
    assert set(figures) == {"risk_coverage", "reliability", "ood_auroc_ood_noise",
                            "ood_auroc_ood_blur", "al_improvement", "triptych", "task_overview"}
    series = json.loads(Path(figures["risk_coverage"]).read_text())["series"]
    assert set(series) == {"softmax_none", "softmax_dropout", "ssn_none", "ssn_dropout"}
    assert all(np.isfinite(s["aurc"]) for s in series.values())
    png = Path(figures["triptych"]).read_bytes()
    assert png.startswith(b"\x89PNG") and len(png) > 500
    md = (report / "REPORT.md").read_text()
    assert "Ran on torch device `cpu`" in md and "](risk_coverage_id.json)" in md
    # one seed: the std columns carry only the rows the two shifts share
    levels = (report / "ds_task_table.csv").read_text().splitlines()[:2]
    groups = "softmax_dropout,softmax_none,ssn_dropout,ssn_none"
    assert levels == [",,,," + ",".join(["mean"] * 4 + ["std"] * 4),
                      f"group,,,,{groups},{groups}"]
    # the members of the trainer's run logged to JSONL only
    run = work / "saves" / "softmax_none" / "s0"
    assert (run / "metrics.jsonl").is_file() and not (run / "tb").exists()


def test_a_second_run_reuses_the_cells(study):
    work, summary, _ = study
    ckpts = sorted((work / "saves").glob("*/*/checkpoints/last/arrays.npz"))
    assert len(ckpts) == 4 + 3  # the matrix and the AL arm's three strategies
    stamps = [p.stat().st_mtime_ns for p in ckpts]
    again = t_study.main([str(work), *MINI])
    assert [p.stat().st_mtime_ns for p in ckpts] == stamps
    assert again["wall_seconds"] < summary["wall_seconds"]
    assert json.dumps(again["checks"]) == json.dumps(summary["checks"])
    assert all(w["train_s"] < 1.0 for w in again["walls"]["cells"].values())


def test_a_matrix_without_the_al_arms_cell_skips_the_arm(study):
    """The AL arm (softmax, dropout) needs its cell: a matrix of the SSN
    alone, its cells reused from the study, skips the arm and still writes
    the report (the JAX study stops with ``StopIteration``)."""
    work, _, _ = study
    argv = list(MINI)
    at = argv.index("--au_types")
    argv[at + 1:at + 3] = ["ssn"]
    again = t_study.main([str(work), *argv])
    assert again["matrix"]["au_types"] == ["ssn"] and again["al"] is None
    assert set(again["walls"]["cells"]) == {"ssn_none_s0", "ssn_dropout_s0"}
    assert all(w["train_s"] < 1.0 for w in again["walls"]["cells"].values())
    assert (work / "report" / "summary.json").is_file()


@pytest.mark.parametrize("argv", [
    ["--quick"],
    ["--epochs", "3", "--seeds", "2", "5", "--au_types", "ssn", "--eu_methods", "none", "swag",
     "--num_test", "6", "--batch_size", "4", "--val_every", "2"]])
def test_command_line_builds_the_jax_study_config(monkeypatch, tmp_path, argv):
    import diffuncertainty_tpu.tools.values_study as j_study

    seen = []
    for mod in (j_study, t_study):
        monkeypatch.setattr(mod, "run_values_study", lambda scfg: seen.append(scfg) or {
            "checks": {}, "wall_seconds": 0.0})
    j_study.main([str(tmp_path), *argv])
    t_study.main([str(tmp_path), *argv, "--device", "cpu"])
    ref, got = (dataclasses.asdict(s) for s in seen)
    assert got.pop("device") == "cpu" and got.pop("loggers") is None
    assert got == ref


def test_the_study_raises_without_a_card_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_study.main([str(tmp_path / "w"), "--quick"])
    assert not (tmp_path / "w").exists()


def test_workdir_parameter_mismatch_raises(tmp_path):
    work = tmp_path / "study"
    work.mkdir()
    (work / "study_meta.json").write_text(json.dumps({"epochs": 3}))
    with pytest.raises(ValueError, match="different study parameters"):
        t_study.run_values_study(t_study.StudyConfig(workdir=work, epochs=6, device="cpu"))


def test_al_arm_rejects_ensemble(tmp_path):
    scfg = t_study.StudyConfig(workdir=tmp_path, al_arm=("softmax", "ensemble"), device="cpu")
    with pytest.raises(ValueError, match="al_arm does not support"):
        t_study._run_al_arm(scfg, tmp_path, tmp_path, tmp_path, seed=0)


@pytest.fixture
def cell(tmp_path):
    from diffuncertainty_tpu_torch.data.toy import generate_toy_dataset

    scfg = t_study.StudyConfig(workdir=tmp_path / "study", epochs=2, num_train=4,
                               batch_size=2, image_size=16, device="cpu", loggers=("jsonl",))
    toy = generate_toy_dataset(tmp_path / "toy", num_train=4, num_val=2, num_test=2,
                               num_ood=2, size=16, seed=0)
    last = scfg.workdir / "saves" / "softmax_none" / "s0" / "checkpoints" / "last"
    last.mkdir(parents=True)
    (last / "config.json").write_text("{}")
    return scfg, toy, toy / "splits" / "default" / "firstCycle" / "splits.pkl", last


@pytest.mark.parametrize("meta", ["{not json", None, json.dumps({"kind": "full"})])
def test_an_unreadable_meta_json_raises_and_leaves_the_cell(cell, meta):
    scfg, toy, splits, last = cell
    if meta is not None:
        (last / "meta.json").write_text(meta)
    before = sorted((p.name, p.read_bytes()) for p in last.iterdir())
    with pytest.raises(RuntimeError, match=str(last / "meta.json")):
        t_study._train_cell(scfg, toy, splits, "softmax", "none", 0, "s0", 0)
    assert sorted((p.name, p.read_bytes()) for p in last.iterdir()) == before


def test_a_stale_cell_is_retrained_and_a_finished_one_kept(cell):
    scfg, toy, splits, last = cell
    (last / "meta.json").write_text(json.dumps({"epoch": 0, "kind": "full"}))
    ckpt = t_study._train_cell(scfg, toy, splits, "softmax", "none", 0, "s0", 0)
    assert ckpt == last and json.loads((last / "meta.json").read_text())["epoch"] == 1
    t0 = time.time()
    stamp = (last / "arrays.npz").stat().st_mtime_ns
    assert t_study._train_cell(scfg, toy, splits, "softmax", "none", 0, "s0", 0) == last
    assert (last / "arrays.npz").stat().st_mtime_ns == stamp and time.time() - t0 < 1.0
