"""The quality rounds' runner (counterpart of scripts/quality_runs.sh,
quality_runs_r4.sh, quality_runs_r5.sh, r5_final_scenes.sh,
r5_blobby_final.sh and r5_blobby_rerun.sh): each round's runs of
`python -m iron_tpu_torch.eval.e2e_validation`, as child processes, with
the shell scripts' scenes, rigs, flags, schedules and run folders.

    python -m iron_tpu_torch.scripts.quality_runs --round ROUND [S1 S2 ...]
        [--results_dir DIR] [--exp_dir DIR] [--device cuda]

  r256             sphere and blobby, 100,000 + 25,000 steps at 256^2,
                   exp_quality_<scene>_r256, each under a 4-hour limit;
  r4               torus (hemisphere), sphere and blobby (ring), independent
                   GT, 100,000 + 50,000 steps, exp_quality_r4_<scene>;
  r5               torus (hemisphere) and sphere (ring), 100,000 + 50,000
                   steps: a control arm (silhouette 0), whose stage1/ is
                   copied into the sil arm (silhouette 0.3) before it runs,
                   so that the sil arm resumes past stage 1;
  r5_final         blobby (ring, B1 + B2 steps, default 26,000 + 8,000), then
                   genus 2 (hemisphere, G1 + G2, default 16,000 + 6,000),
                   silhouette 0.3: positional B1 B2 G1 G2;
  r5_blobby_final  blobby, S1 + S2 (default 100,000 + 25,000);
  r5_blobby_rerun  blobby, S1 + S2 (default 18,000 + 6,000).

r4 and r5 run each child under the shell scripts' watchdog: up to 4
attempts (the trainers resume inside their run folder, so a retry goes on
where the last stopped), an attempt killed when its log has not grown for
15 polls of a minute or has run 240 (r4) or 200 (r5) minutes; the log's
last 40 (r4) or 25 (r5) lines without WARNING shown after each attempt.
The other rounds show the child's output as it comes, without WARNING
lines.  After a run, its report.json and testviews.png are copied into
DIR under the JAX record's names (quality_<scene>_r4_independent.json,
quality_<scene>_r5_<arm>.json, ...), where the shell scripts copy them
into results/.  DIR defaults to results/torch/; a folder of the JAX record
(results/ itself, or any folder under it but results/torch/) is refused,
so no file of that record is written over.  The run folders go under
--exp_dir (default: the current folder, as the shell scripts run from the
repo's root), the attempts' logs under the system's temporary folder.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_RECORD = os.path.join(REPO, "results")
RESULTS = os.path.join(JAX_RECORD, "torch")
CHILD = (sys.executable, "-u", "-m", "iron_tpu_torch.eval.e2e_validation")
SAMPLES = ("--n_samples", "64", "--n_importance", "64")
ATTEMPTS = 4         # the watchdog's tries of a run
STALL_POLLS = 15     # polls without log growth that kill an attempt


@dataclass(frozen=True)
class Watchdog:
    """quality_runs_r4.sh's and quality_runs_r5.sh's: an attempt killed
    after `overrun` polls in all; `tail` lines of its log shown after it;
    `log` the log's name, with {attempt} filled in."""
    overrun: int
    tail: int
    log: str


@dataclass(frozen=True)
class Run:
    """One child: e2e_validation with `flags` and --out_dir `out_dir`;
    `timeout_s` a hard limit (quality_runs.sh's `timeout 14400`)."""
    out_dir: str
    flags: Tuple[str, ...]
    watchdog: Optional[Watchdog] = None
    timeout_s: Optional[float] = None
    banner: Optional[str] = None


@dataclass(frozen=True)
class Share:
    """quality_runs_r5.sh's fork: `src`'s finished stage1/ copied into `dst`
    where `dst` has none."""
    src: str
    dst: str


@dataclass(frozen=True)
class Copy:
    """A run's file copied into the results folder under `name`, skipped
    with a note where the run did not write it."""
    src: str
    name: str


def _flags(scene: str, rig: Optional[str], s1, s2, independent: bool = True,
           silhouette: Optional[str] = None) -> Tuple[str, ...]:
    f = ["--scene", scene] + (["--rig", rig] if rig else []) + ["--res", "256"]
    f += ["--independent_gt"] if independent else []
    f += ["--stage1_iters", str(s1), "--stage2_iters", str(s2), *SAMPLES]
    return tuple(f + (["--silhouette_weight", silhouette] if silhouette is not None else []))


def _copies(out: str, report: str, views: str) -> List[Copy]:
    return [Copy(os.path.join(out, "report.json"), report),
            Copy(os.path.join(out, "testviews.png"), views)]


def _overrides(args: Sequence[str], defaults: Sequence[int]) -> List[str]:
    if len(args) > len(defaults):
        raise ValueError(f"at most {len(defaults)} schedule overrides, got {list(args)}")
    return [str(a) for a in args] + [str(d) for d in defaults[len(args):]]


def _blobby_sil(s1, s2, banner: Optional[str] = None) -> list:
    out = "exp_r5_blobby_sil"
    return [Run(out, _flags("blobby", "ring", s1, s2, silhouette="0.3"), banner=banner),
            *_copies(out, "quality_blobby_r5_sil.json", "quality_blobby_r5_sil_testviews.png")]


def plan(round_name: str, overrides: Sequence[str] = ()) -> list:
    """A round's steps in the shell script's order: Run, Share and Copy."""
    if round_name == "r256":
        _overrides(overrides, ())
        return [Run(f"exp_quality_{s}_r256", _flags(s, None, 100000, 25000, independent=False),
                    timeout_s=14400.0) for s in ("sphere", "blobby")]
    if round_name == "r4":
        _overrides(overrides, ())
        steps = []
        for scene, rig in (("torus", "hemisphere"), ("sphere", "ring"), ("blobby", "ring")):
            out = f"exp_quality_r4_{scene}"
            steps += [Run(out, _flags(scene, rig, 100000, 50000),
                          watchdog=Watchdog(240, 40, f"e2e_{scene}_{{attempt}}.log")),
                      *_copies(out, f"quality_{scene}_r4_independent.json",
                               f"quality_{scene}_r4_testviews.png")]
        return steps
    if round_name == "r5":
        _overrides(overrides, ())
        steps = []
        for scene, rig in (("torus", "hemisphere"), ("sphere", "ring")):
            ctrl, sil = f"exp_r5_{scene}_control", f"exp_r5_{scene}_sil"
            arm = lambda out, w: Run(out, _flags(scene, rig, 100000, 50000, silhouette=w),
                                     watchdog=Watchdog(200, 25, f"r5_{out}_{{attempt}}.log"))
            steps += [arm(ctrl, "0"), Share(ctrl, sil), arm(sil, "0.3")]
            for a, out in (("control", ctrl), ("sil", sil)):
                steps += _copies(out, f"quality_{scene}_r5_{a}.json",
                                 f"quality_{scene}_r5_{a}_testviews.png")
        return steps
    if round_name == "r5_final":
        b1, b2, g1, g2 = _overrides(overrides, (26000, 8000, 16000, 6000))
        out = "exp_r5_genus2_sil"
        return [*_blobby_sil(b1, b2, banner=f"blobby {b1}/{b2}"),
                Run(out, _flags("genus2", "hemisphere", g1, g2, silhouette="0.3"),
                    banner=f"genus2 {g1}/{g2}"),
                *_copies(out, "quality_genus2_r5_sil.json",
                         "quality_genus2_r5_sil_testviews.png")]
    if round_name == "r5_blobby_final":
        return _blobby_sil(*_overrides(overrides, (100000, 25000)))
    if round_name == "r5_blobby_rerun":
        s1, s2 = _overrides(overrides, (18000, 6000))
        return _blobby_sil(s1, s2, banner=f"blobby {s1}/{s2}")
    raise ValueError(f"unknown round {round_name!r}; one of {ROUNDS}")


ROUNDS = ("r256", "r4", "r5", "r5_final", "r5_blobby_final", "r5_blobby_rerun")


def check_results_dir(path: str) -> str:
    """`path`, made absolute, unless it is a folder of the JAX record:
    results/ or one under it other than results/torch/."""
    real, record, port = (os.path.realpath(p) for p in (path, JAX_RECORD, RESULTS))
    inside = lambda a, b: a == b or a.startswith(b + os.sep)
    if inside(real, record) and not inside(real, port):
        raise ValueError(f"{path} is a folder of the JAX package's record; the port's reports "
                         f"go to {RESULTS} or a folder outside {JAX_RECORD}")
    return os.path.abspath(path)


def _without_warnings(lines: Sequence[str]) -> List[str]:
    return [ln for ln in lines if "WARNING" not in ln]


def watch(cmd: Sequence[str], log_path: str, stall: int = STALL_POLLS, overrun: int = 240,
          poll_s: float = 60.0, label: str = "", cwd: Optional[str] = None) -> bool:
    """One attempt under the watchdog: `cmd` with its output in `log_path`,
    polled every `poll_s` seconds; killed once its log has not grown for
    `stall` polls or it has run `overrun` polls.  Returns whether it was
    killed."""
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(list(cmd), stdout=log, stderr=subprocess.STDOUT, cwd=cwd)
    last, still, polls = -1, 0, 0
    try:
        while True:
            try:
                proc.wait(timeout=poll_s)
                return False
            except subprocess.TimeoutExpired:
                pass
            polls += 1
            size = os.path.getsize(log_path) if os.path.exists(log_path) else 0
            still = still + 1 if size == last else 0
            last = size
            if still >= stall or polls >= overrun:
                print(f"=== watchdog: {label} stalled/overran (stall={still} mins={polls}); "
                      f"killing {proc.pid} ===", flush=True)
                proc.kill()
                return True
    finally:
        proc.wait()


def _run_plain(cmd: Sequence[str], timeout_s: Optional[float], cwd: str) -> int:
    """The child with its output shown as it comes, without WARNING lines;
    terminated after `timeout_s` seconds if given."""
    with subprocess.Popen(list(cmd), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, cwd=cwd) as proc:
        timer = threading.Timer(timeout_s, proc.terminate) if timeout_s else None
        if timer:
            timer.start()
        try:
            for line in proc.stdout:
                if "WARNING" not in line:
                    print(line, end="", flush=True)
            return proc.wait()
        finally:
            if timer:
                timer.cancel()


def run_round(round_name: str, overrides: Sequence[str] = (), results_dir: str = RESULTS,
              exp_dir: str = ".", device: str = "cuda", child: Sequence[str] = CHILD,
              poll_s: float = 60.0, log_dir: Optional[str] = None) -> List[str]:
    """Run a round's steps (`plan`): each child is `child` + its flags +
    --out_dir + --device, run in `exp_dir`; the watchdog polls every
    `poll_s` seconds; logs go to `log_dir` (default the system's temporary
    folder).  Returns the names copied into `results_dir`."""
    results_dir = check_results_dir(results_dir)
    steps = plan(round_name, overrides)
    exp_dir = os.path.abspath(exp_dir)
    log_dir = log_dir or tempfile.gettempdir()
    os.makedirs(results_dir, exist_ok=True)
    at = lambda p: os.path.join(exp_dir, p)
    copied = []
    for step in steps:
        if isinstance(step, Run):
            cmd = [*child, *step.flags, "--out_dir", step.out_dir, "--device", device]
            if step.banner:
                print(f"=== {step.banner} ({time.strftime('%H:%M:%S', time.gmtime())}) ===",
                      flush=True)
            if step.watchdog is None:
                _run_plain(cmd, step.timeout_s, exp_dir)
                continue
            wd = step.watchdog
            for attempt in range(1, ATTEMPTS + 1):
                log = os.path.join(log_dir, wd.log.format(attempt=attempt))
                watch(cmd, log, STALL_POLLS, wd.overrun, poll_s,
                      label=f"{step.out_dir} attempt {attempt}", cwd=exp_dir)
                with open(log, errors="replace") as fh:
                    tail = _without_warnings(fh.read().splitlines())[-wd.tail:]
                print("\n".join(tail), flush=True)
                if os.path.exists(at(os.path.join(step.out_dir, "report.json"))):
                    break
                print(f"=== attempt {attempt} for {step.out_dir} did not finish; retrying ===",
                      flush=True)
        elif isinstance(step, Share):
            if os.path.isdir(at(os.path.join(step.src, "stage1"))) and \
                    not os.path.isdir(at(os.path.join(step.dst, "stage1"))):
                os.makedirs(at(step.dst), exist_ok=True)
                shutil.copytree(at(os.path.join(step.src, "stage1")),
                                at(os.path.join(step.dst, "stage1")))
        else:
            if os.path.exists(at(step.src)):
                shutil.copyfile(at(step.src), os.path.join(results_dir, step.name))
                copied.append(step.name)
            else:
                print(f"{step.src} not written: {step.name} not copied", flush=True)
    return copied


def main(argv=None) -> List[str]:
    p = argparse.ArgumentParser(description="Run a quality round of e2e_validation on the port.")
    p.add_argument("--round", required=True, choices=ROUNDS)
    p.add_argument("schedule", nargs="*", type=int,
                   help="stage-1 / stage-2 iterations: r5_final's B1 B2 G1 G2, the blobby "
                        "rounds' S1 S2")
    p.add_argument("--results_dir", default=RESULTS,
                   help="where the reports are copied (default results/torch/)")
    p.add_argument("--exp_dir", default=".", help="where the run folders go")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu for a dry run)")
    args = p.parse_args(argv)
    return run_round(args.round, [str(s) for s in args.schedule], args.results_dir,
                     args.exp_dir, args.device)


if __name__ == "__main__":
    main()
