"""The port's e2e_validation for a run split over calls of limited time:
`python -m iron_tpu_torch.eval.e2e_validation` with the same flags, but a
stage-2 checkpoint every 1,000 steps (5,000 in the module), keeping only
the newest and the 5,000-step one, so that a call cut at its limit
resumes within 1,000 steps of where it stopped.  The report's chamfer
trajectory gains the last numbered checkpoint (stage2_<stage2_iters>),
which holds the final parameters.

    python3 scripts/e2e_in_calls_torch.py --scene genus2 --rig hemisphere --res 256 \\
        --independent_gt --stage1_iters 16000 --stage2_iters 6000 --n_samples 64 \\
        --n_importance 64 --silhouette_weight 0.3 --out_dir RUN

Run it again with the same --out_dir to go on: stage 1 resumes from its
end, stage 2 from its newest checkpoint (with a fresh Adam, as the
stage-2 checkpoints of both packages hold no optimizer state).
"""
import dataclasses
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from iron_tpu_torch.eval import e2e_validation  # noqa: E402
from iron_tpu_torch.train.stage2 import Stage2Trainer  # noqa: E402

SAVE_EVERY = 1000
KEEP_EVERY = 5000    # the module's own cadence: these checkpoints stay


def main(argv=None):
    stage2_config = e2e_validation.stage2_config
    save = Stage2Trainer.save

    def save_and_prune(self):
        save(self)
        for path in glob.glob(os.path.join(self.out_dir or "", "ckpt_*.pkl")):
            step = os.path.basename(path)[5:-4]
            if step.isdigit() and int(step) % KEEP_EVERY and int(step) < self.step:
                os.remove(path)

    e2e_validation.stage2_config = lambda args: dataclasses.replace(stage2_config(args),
                                                                    save_freq=SAVE_EVERY)
    Stage2Trainer.save = save_and_prune
    try:
        return e2e_validation.main(argv)
    finally:
        e2e_validation.stage2_config = stage2_config
        Stage2Trainer.save = save


if __name__ == "__main__":
    main()
