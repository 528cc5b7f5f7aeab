"""Learning-rate and annealing schedules (counterpart of
iron_tpu/train/schedules.py).  Of a Python number they return a host float
(no device work); of a tensor step count, an f32 tensor on its device,
computed as the JAX package computes it (what a captured CUDA graph reads
at each replay):

  * lr factor = step / warm_up_end while warming up, then
    alpha + (1 - alpha) * 0.5 * (1 + cos(pi * progress));
  * cos_anneal_ratio = min(1, step / anneal_end).
"""
from __future__ import annotations

import math

import torch


def warmup_cosine_schedule(base_lr: float, warm_up_end: int, end_iter: int,
                           alpha: float = 0.05):
    """step -> lr."""
    def schedule(step):
        if isinstance(step, torch.Tensor):
            step = step.to(torch.float32)
            warm = step / max(warm_up_end, 1)
            progress = (step - warm_up_end) / max(end_iter - warm_up_end, 1)
            cos_f = (torch.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha
            return base_lr * torch.where(step < warm_up_end, warm, cos_f)
        step = float(step)
        if step < warm_up_end:
            return base_lr * step / max(warm_up_end, 1)
        progress = (step - warm_up_end) / max(end_iter - warm_up_end, 1)
        return base_lr * ((math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha)

    return schedule


def cos_anneal_ratio(step, anneal_end: int):
    if anneal_end == 0:
        return 1.0
    if isinstance(step, torch.Tensor):
        return torch.clamp(step.to(torch.float32) / anneal_end, max=1.0)
    return min(1.0, float(step) / anneal_end)
