"""Per-scene batch job generation — the `gen_ibex_scripts.py` equivalent
(counterpart of iron_tpu/cli/gen_jobs.py, launching the port's CLIs on one
GPU each).

The reference's only multi-node story is embarrassingly-parallel per-scene
SLURM jobs (gen_ibex_scripts.py:26-66: one GPU, 23.5h walltime each).  This
generator emits either SLURM scripts or plain shell launchers running the
full two-stage pipeline (train_volume -> train_surface -> render/export)
per scene; scenes are independent, so scale-out is trivial.  The stage-2
command takes the newest `ckpt_*.pkl` of the stage-1 run, which the port's
async saves write.
"""
from __future__ import annotations

import argparse
import os
import stat

TEMPLATE_SHELL = """#!/bin/bash
set -euo pipefail
# scene: {case}
python -m iron_tpu_torch.cli.train_volume --mode train --conf {conf} --case {case} \\
    --out_dir {exp_dir}/stage1/{case}
python -m iron_tpu_torch.cli.train_surface --data_dir {data_dir}/{case}/train \\
    --out_dir {exp_dir}/stage2/{case} \\
    --neus_ckpt_fpath $(ls {exp_dir}/stage1/{case}/ckpt_*.pkl | sort | tail -1) \\
    --gamma_pred {extra_flags}
python -m iron_tpu_torch.cli.train_surface --data_dir {data_dir}/{case}/test \\
    --out_dir {exp_dir}/stage2/{case} --render_all --gamma_pred {extra_flags}
"""

TEMPLATE_SLURM = """#!/bin/bash
#SBATCH -N 1
#SBATCH -J iron_{case}
#SBATCH -o {exp_dir}/logs/{case}.%J.out
#SBATCH -e {exp_dir}/logs/{case}.%J.err
#SBATCH --time={walltime}
{gres}
""" + "\n" + TEMPLATE_SHELL.split("\n", 2)[2]


def generate(scenes, conf: str, data_dir: str, exp_dir: str, out_dir: str,
             slurm: bool = False, walltime: str = "23:30:00",
             gres: str = "#SBATCH --gres=gpu:1", extra_flags: str = ""):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for case in scenes:
        tpl = TEMPLATE_SLURM if slurm else TEMPLATE_SHELL
        text = tpl.format(case=case, conf=conf, data_dir=data_dir,
                          exp_dir=exp_dir, walltime=walltime, gres=gres,
                          extra_flags=extra_flags)
        path = os.path.join(out_dir, f"run_{case}.sh")
        with open(path, "w") as f:
            f.write(text)
        os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
        paths.append(path)
    launcher = os.path.join(out_dir, "submit_all.sh")
    with open(launcher, "w") as f:
        f.write("#!/bin/bash\n")
        for p in paths:
            f.write((f"sbatch {p}\n") if slurm else (f"bash {p} &\n"))
        if not slurm:
            f.write("wait\n")
    os.chmod(launcher, os.stat(launcher).st_mode | stat.S_IEXEC)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scenes", nargs="+", required=True)
    p.add_argument("--conf", default="iron_tpu_torch/configs/womask_iron.json")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--exp_dir", default="./exp")
    p.add_argument("--out_dir", default="./jobs")
    p.add_argument("--slurm", action="store_true")
    p.add_argument("--walltime", default="23:30:00")
    p.add_argument("--extra_flags", default="")
    args = p.parse_args(argv)
    paths = generate(args.scenes, args.conf, args.data_dir, args.exp_dir,
                     args.out_dir, args.slurm, args.walltime,
                     extra_flags=args.extra_flags)
    print(f"wrote {len(paths)} job scripts to {args.out_dir}")


if __name__ == "__main__":
    main()
