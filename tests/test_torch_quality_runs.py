"""The quality rounds' runner and tables on the port
(iron_tpu_torch/scripts/quality_runs.py, format_results.py) against the
JAX package's scripts/quality_runs.sh, quality_runs_r4.sh,
quality_runs_r5.sh, r5_final_scenes.sh, r5_blobby_final.sh,
r5_blobby_rerun.sh, format_r4_results.py and format_r5_results.py:

  * format_results prints byte for byte what the JAX table scripts print,
    on the repo's results/ (the JAX record), on results/torch/ (the port's
    reports) and on reports that carry the port's `device` key (the JAX
    scripts run as child processes from a copy beside a results/ folder of
    their own: they read the folder next to them);
  * every round's children and copies are the shell script's: each shell
    script runs from a copy whose python is a recorder (its `sleep 60`
    polls cut to 0.01 s), the port's round with the same recorder as its
    child, and both record the same flags and run folders, in the same
    order, the same stage1/ folders present at each launch, and the same
    files copied into results/;
  * the watchdog kills a child whose log stops growing or that overruns,
    and the round retries until the run folder holds report.json (polls of
    a fraction of a second);
  * at a tiny CPU schedule (narrow networks, 32^2, 4 + 2 steps), r5's sil
    arm of the torus resumes from the control arm's copied stage1/ and
    takes no stage-1 step;
  * results/ itself, and folders of it but results/torch/, are refused.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
import time

import pytest
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)

from iron_tpu_torch.scripts import format_results, quality_runs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHELL = {"r256": "quality_runs.sh", "r4": "quality_runs_r4.sh", "r5": "quality_runs_r5.sh",
         "r5_final": "r5_final_scenes.sh", "r5_blobby_final": "r5_blobby_final.sh",
         "r5_blobby_rerun": "r5_blobby_rerun.sh"}


def _jax_table(tmp_path, round_name: str, results_dir: str) -> str:
    """The JAX table script's output on `results_dir`'s reports: the script
    copied into tmp/scripts/, the reports into tmp/results/ (the folder it
    reads)."""
    root = tmp_path / f"jax_{round_name}"
    (root / "scripts").mkdir(parents=True)
    shutil.copytree(results_dir, root / "results",
                    ignore=shutil.ignore_patterns("*.png", "torch"))
    script = f"format_{round_name}_results.py"
    shutil.copy(os.path.join(REPO, "scripts", script), root / "scripts" / script)
    out = subprocess.run([sys.executable, str(root / "scripts" / script)], capture_output=True,
                         text=True, timeout=60, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _port_table(round_name: str, *extra) -> str:
    out = subprocess.run([sys.executable, "-m", "iron_tpu_torch.scripts.format_results",
                          "--round", round_name, *extra], capture_output=True, text=True,
                         timeout=60, cwd=REPO)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("round_name", ["r4", "r5"])
def test_format_results_prints_the_jax_tables_on_the_record(round_name):
    """`python -m iron_tpu_torch.scripts.format_results --round R` and
    `python scripts/format_R_results.py`, both on the repo's results/."""
    jax = subprocess.run([sys.executable, os.path.join("scripts", f"format_{round_name}_results.py")],
                         capture_output=True, text=True, timeout=60, cwd=REPO)
    assert jax.returncode == 0, jax.stderr
    assert jax.stdout.count("\n") >= 3
    assert _port_table(round_name) == jax.stdout


@pytest.mark.parametrize("round_name", ["r4", "r5"])
@pytest.mark.parametrize("source", ["the JAX record with device keys", "results/torch"])
def test_format_results_prints_the_jax_tables_on_port_reports(round_name, source, tmp_path):
    """The port's reports (the JAX keys and `device`): the JAX record's
    reports with a `device` record added, and the port's own reports in
    results/torch/, through both packages' table scripts."""
    if source == "results/torch":
        src = os.path.join(REPO, "results", "torch")
    else:
        src = tmp_path / "reports"
        src.mkdir()
        for name in os.listdir(os.path.join(REPO, "results")):
            if name.endswith(".json"):
                with open(os.path.join(REPO, "results", name)) as fh:
                    rep = json.load(fh)
                rep["device"] = {"type": "cuda", "name": "NVIDIA H100 80GB HBM3"}
                (src / name).write_text(json.dumps(rep))
    want = _jax_table(tmp_path, round_name, str(src))
    assert _port_table(round_name, "--results_dir", str(src)) == want
    assert format_results.main(["--round", round_name, "--results_dir", str(src)]) + "\n" == want


def test_format_results_port_genus2_row():
    """The port's genus-2 report prints its row and trajectory in r5's table."""
    text = _port_table("r5", "--results_dir", os.path.join(REPO, "results", "torch"))
    assert "| genus2 | sil |" in text and "genus2/sil trajectory: 5k:" in text


# ---------------------------------------------------------------------------
# the rounds against the shell scripts
# ---------------------------------------------------------------------------

# records each call (its arguments and which run folders held stage1/ at its
# start), then writes the run's report.json, testviews.png and stage1/
RECORDER = textwrap.dedent("""\
    import json, os, sys
    argv = sys.argv[1:]
    while argv and (argv[0] == "-u" or argv[0].endswith("e2e_validation.py")):
        argv = argv[1:]
    if argv[-2:-1] == ["--device"]:
        argv = argv[:-2]
    out = argv[argv.index("--out_dir") + 1]
    with open(os.environ["RECORD"], "a") as fh:
        fh.write(json.dumps({"argv": argv, "stage1": sorted(
            d for d in os.listdir(".") if os.path.isdir(os.path.join(d, "stage1")))}) + "\\n")
    os.makedirs(os.path.join(out, "stage1"), exist_ok=True)
    with open(os.path.join(out, "stage1", "record.json"), "w") as fh:
        fh.write(out)
    for name in ("report.json", "testviews.png"):
        with open(os.path.join(out, name), "w") as fh:
            fh.write(out + name)
    print("WARNING a line the runners drop")
    print("done", out)
""")


def _calls(record) -> list:
    with open(record) as fh:
        return [json.loads(line) for line in fh]


def _results(root) -> dict:
    d = os.path.join(root, "results")
    return {n: open(os.path.join(d, n)).read() for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("round_name,overrides", [
    ("r256", ()), ("r4", ()), ("r5", ()), ("r5_final", ()), ("r5_final", ("0", "0", "16000", "6000")),
    ("r5_blobby_final", ()), ("r5_blobby_final", ("5000",)), ("r5_blobby_rerun", ()),
    ("r5_blobby_rerun", ("14000", "5000"))])
def test_round_runs_and_copies_what_its_shell_script_does(round_name, overrides, tmp_path):
    """The shell script (a copy, its python the recorder, its polls cut)
    and the port's round (the recorder as its child) record the same calls
    in the same order, each launched with the same run folders holding
    stage1/ (r5's sil arm finds the control arm's copy), and copy the same
    files into results/."""
    recorder = tmp_path / "recorder.py"
    recorder.write_text(RECORDER)
    fake_py = tmp_path / "python"
    fake_py.write_text(f'#!/bin/bash\nexec {sys.executable} {recorder} "$@"\n')
    fake_py.chmod(0o755)
    # the shell script, from a copy of its own folder layout
    sh_root = tmp_path / "sh"
    (sh_root / "scripts").mkdir(parents=True)
    (sh_root / "results").mkdir()
    with open(os.path.join(REPO, "scripts", SHELL[round_name])) as fh:
        script = fh.read()
    python = re.compile(r"(?<=[\s=])/\S*/bin/python(?=\s)")
    assert python.search(script)
    script = (python.sub(str(fake_py), script)
              .replace("sleep 60", "sleep 0.01").replace("log=/tmp/", f"log={tmp_path}/"))
    (sh_root / "scripts" / "run.sh").write_text(script)
    env = dict(os.environ, RECORD=str(tmp_path / "sh.jsonl"), TMPDIR=str(tmp_path))
    out = subprocess.run(["bash", str(sh_root / "scripts" / "run.sh"), *overrides], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # the port's round, with the recorder as its child
    port_root = tmp_path / "port"
    port_root.mkdir()
    os.environ["RECORD"] = str(tmp_path / "port.jsonl")
    try:
        copied = quality_runs.run_round(round_name, overrides, str(port_root / "results"),
                                        str(port_root), "cuda",
                                        child=(sys.executable, str(recorder)), poll_s=0.01,
                                        log_dir=str(tmp_path))
    finally:
        del os.environ["RECORD"]
    sh_calls, port_calls = _calls(tmp_path / "sh.jsonl"), _calls(tmp_path / "port.jsonl")
    assert port_calls == sh_calls
    assert len(port_calls) == sum(isinstance(s, quality_runs.Run)
                                  for s in quality_runs.plan(round_name, overrides))
    assert _results(port_root) == _results(sh_root)
    assert sorted(copied) == sorted(_results(sh_root))
    if round_name == "r5":
        assert [c["stage1"] for c in port_calls] == [
            [], ["exp_r5_torus_control", "exp_r5_torus_sil"],
            ["exp_r5_torus_control", "exp_r5_torus_sil"],
            ["exp_r5_sphere_control", "exp_r5_sphere_sil", "exp_r5_torus_control",
             "exp_r5_torus_sil"]]


def test_round_flags_are_e2e_validations():
    """Every round's flags parse with the port's e2e_validation."""
    from iron_tpu_torch.eval import e2e_validation
    for name in quality_runs.ROUNDS:
        for step in quality_runs.plan(name):
            if isinstance(step, quality_runs.Run):
                args = e2e_validation.parse_args([*step.flags, "--out_dir", step.out_dir])
                assert args.res == 256 and args.n_samples == args.n_importance == 64


def _child(tmp_path, body: str):
    p = tmp_path / "child.py"
    p.write_text(textwrap.dedent(body))
    return [sys.executable, str(p)]


def test_watchdog_kills_a_stalled_and_an_overrunning_child(tmp_path):
    """watch() at 0.1 s polls: a child that prints once and sleeps is killed
    after 3 polls without log growth, one that keeps printing after 8 polls
    in all, one that ends is left alone."""
    stalled = _child(tmp_path, "import time\nprint('once', flush=True)\ntime.sleep(60)\n")
    t = time.time()
    assert quality_runs.watch(stalled, str(tmp_path / "a.log"), stall=3, overrun=100, poll_s=0.1)
    assert time.time() - t < 10
    chatty = [sys.executable, "-c", "import time\nwhile True:\n print('x', flush=True)\n"
              " time.sleep(0.02)"]
    t = time.time()
    assert quality_runs.watch(chatty, str(tmp_path / "b.log"), stall=3, overrun=8, poll_s=0.1)
    assert 0.7 < time.time() - t < 10
    assert os.path.getsize(tmp_path / "b.log") > 0
    done = [sys.executable, "-c", "print('ok')"]
    assert not quality_runs.watch(done, str(tmp_path / "c.log"), poll_s=0.1)
    assert (tmp_path / "c.log").read_text() == "ok\n"


def test_round_retries_a_stalled_child_until_the_report(tmp_path, monkeypatch, capsys):
    """r4's torus run under the watchdog (15 polls of 0.02 s without log
    growth): a child that stalls on its first two attempts and writes
    report.json on its third is killed twice and run three times; the
    next scenes' children end at once."""
    child = _child(tmp_path, """\
        import os, sys, time
        out = sys.argv[sys.argv.index("--out_dir") + 1]
        os.makedirs(out, exist_ok=True)
        n = len(os.listdir(out))
        open(os.path.join(out, f"attempt{n}"), "w").close()
        print("attempt", n, flush=True)
        if "torus" in out and n < 2:
            time.sleep(60)
        open(os.path.join(out, "report.json"), "w").write("{}")
    """)
    copied = quality_runs.run_round("r4", (), str(tmp_path / "results"), str(tmp_path),
                                    child=child, poll_s=0.02, log_dir=str(tmp_path))
    text = capsys.readouterr().out
    assert text.count("=== watchdog: exp_quality_r4_torus attempt") == 2
    assert "=== attempt 2 for exp_quality_r4_torus did not finish; retrying ===" in text
    assert sorted(os.listdir(tmp_path / "exp_quality_r4_torus")) == [
        "attempt0", "attempt1", "attempt2", "report.json"]
    assert sorted(os.listdir(tmp_path / "exp_quality_r4_sphere")) == ["attempt0", "report.json"]
    assert copied == [f"quality_{s}_r4_independent.json" for s in ("torus", "sphere", "blobby")]
    for a in (1, 2, 3):
        assert (tmp_path / f"e2e_torus_{a}.log").exists()


TINY = textwrap.dedent("""\
    import dataclasses, sys
    import torch
    torch.set_num_threads(1)
    from iron_tpu_torch.eval import e2e_validation as E
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.train.stage1 import STAGE1_COLOR
    NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
    argv = sys.argv[1:]
    for flag, value in (("--res", "32"), ("--n_samples", "8"), ("--n_importance", "8"),
                        ("--stage1_iters", "4"), ("--stage2_iters", "2"), ("--device", "cpu")):
        argv[argv.index(flag) + 1] = value
    args = E.parse_args(argv)
    s1 = dataclasses.replace(E.stage1_config(args), sdf=SDFConfig(bias=0.5, **NARROW),
                             color=dataclasses.replace(STAGE1_COLOR, d_feature=32, d_hidden=32,
                                                       n_layers=4, skip_in=(2,)))
    s2 = dataclasses.replace(E.stage2_config(args), save_freq=2, sdf=SDFConfig(**NARROW))
    E.run(args, s1, s2, "cpu", mesh_resolution=32, gt_mesh_resolution=64)
""")


def test_r5_sil_arm_resumes_from_the_shared_stage1(tmp_path, monkeypatch):
    """r5's torus steps (control arm, the fork, sil arm, the copies) with
    e2e_validation itself as the child, cut to narrow networks, 32^2
    views and 4 + 2 steps on the CPU: the control arm trains stage 1, its
    stage1/ is copied into the sil arm's folder, and the sil arm reports
    the control arm's stage-1 record resumed at its end, logs no stage-1
    step, and trains its own stage 2."""
    torus = [s for s in quality_runs.plan("r5") if "torus" in (getattr(s, "out_dir", "")
                                                              or getattr(s, "src", ""))]
    assert len(torus) == 7
    monkeypatch.setattr(quality_runs, "plan", lambda name, overrides=(): torus)
    child = tmp_path / "tiny.py"
    child.write_text(TINY)
    monkeypatch.setenv("PYTHONPATH", REPO)
    copied = quality_runs.run_round("r5", (), str(tmp_path / "results"), str(tmp_path),
                                    device="cpu", child=(sys.executable, str(child)),
                                    poll_s=0.5, log_dir=str(tmp_path))
    assert copied == ["quality_torus_r5_control.json", "quality_torus_r5_control_testviews.png",
                      "quality_torus_r5_sil.json", "quality_torus_r5_sil_testviews.png"]
    ctrl, sil = (json.loads((tmp_path / "results" / f"quality_torus_r5_{a}.json").read_text())
                 for a in ("control", "sil"))
    assert ctrl["stage1"]["resumed_at"] == 0 and "loss" in ctrl["stage1"]
    assert sil["stage1"] == {**ctrl["stage1"], "resumed_at": 4}
    sil_log = (tmp_path / "r5_exp_r5_torus_sil_1.log").read_text()
    assert "[stage1] resumed at 4" in sil_log and "[stage1 " not in sil_log.replace(
        "[stage1] ", "")
    assert "[stage1 " in (tmp_path / "r5_exp_r5_torus_control_1.log").read_text()
    for a in ("control", "sil"):
        assert os.listdir(tmp_path / f"exp_r5_torus_{a}" / "stage2")
    with open(tmp_path / "exp_r5_torus_control" / "stage1" / "ckpt_0000004.pkl", "rb") as a, \
            open(tmp_path / "exp_r5_torus_sil" / "stage1" / "ckpt_0000004.pkl", "rb") as b:
        assert a.read() == b.read()
    assert ctrl["stage2"] != sil["stage2"]


@pytest.mark.parametrize("where", ["results", "results/../results", "results/other"])
def test_the_jax_record_is_refused(where, tmp_path):
    """results/ and its folders but results/torch/ are refused before any
    run; results/torch/ and a folder elsewhere are taken."""
    with pytest.raises(ValueError, match="JAX package's record"):
        quality_runs.run_round("r4", (), os.path.join(REPO, where), str(tmp_path),
                               child=(sys.executable, "-c", "raise SystemExit(1)"))
    assert quality_runs.check_results_dir(os.path.join(REPO, "results", "torch"))
    assert quality_runs.check_results_dir(str(tmp_path / "elsewhere"))


def test_e2e_in_calls_saves_every_1000_steps_and_keeps_the_newest(tmp_path, monkeypatch):
    """scripts/e2e_in_calls_torch.py runs e2e_validation with a stage-2
    checkpoint every 1,000 steps, keeping the newest and the 5,000-step
    ones, and restores the module afterwards."""
    import importlib.util
    import types
    from iron_tpu_torch.eval import e2e_validation
    from iron_tpu_torch.train.stage2 import Stage2Trainer
    spec = importlib.util.spec_from_file_location(
        "e2e_in_calls_torch", os.path.join(REPO, "scripts", "e2e_in_calls_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    def write(self):
        open(os.path.join(self.out_dir, f"ckpt_{self.step:07d}.pkl"), "w").close()

    seen = []

    def fake_main(argv):
        args = e2e_validation.parse_args(argv)
        assert e2e_validation.stage2_config(args).save_freq == 1000
        tr = types.SimpleNamespace(out_dir=str(tmp_path), step=0)
        for step in range(1000, 7000, 1000):
            tr.step = step
            Stage2Trainer.save(tr)
            seen.append(sorted(os.listdir(tmp_path)))
        return "report"

    monkeypatch.setattr(Stage2Trainer, "save", write)
    monkeypatch.setattr(e2e_validation, "main", fake_main)
    assert script.main(["--device", "cpu"]) == "report"
    assert seen[2] == ["ckpt_0003000.pkl"]
    assert seen[-1] == ["ckpt_0005000.pkl", "ckpt_0006000.pkl"]
    assert Stage2Trainer.save is write
    assert e2e_validation.stage2_config(e2e_validation.parse_args([])).save_freq == 5000
