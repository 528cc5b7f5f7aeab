"""Learning-rate and annealing schedules (counterpart of
iron_tpu/train/schedules.py), as host floats of the step count: the
trainer sets them on the optimizer and the render, with no device work.

  * lr factor = step / warm_up_end while warming up, then
    alpha + (1 - alpha) * 0.5 * (1 + cos(pi * progress));
  * cos_anneal_ratio = min(1, step / anneal_end).
"""
from __future__ import annotations

import math


def warmup_cosine_schedule(base_lr: float, warm_up_end: int, end_iter: int,
                           alpha: float = 0.05):
    """step -> lr."""
    def schedule(step) -> float:
        step = float(step)
        if step < warm_up_end:
            return base_lr * step / max(warm_up_end, 1)
        progress = (step - warm_up_end) / max(end_iter - warm_up_end, 1)
        return base_lr * ((math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)

    return schedule


def cos_anneal_ratio(step, anneal_end: int) -> float:
    if anneal_end == 0:
        return 1.0
    return min(1.0, float(step) / anneal_end)
