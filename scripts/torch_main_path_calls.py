"""The inputs that the port's main paths hand K1 (coarse_march), K2
(sdf_only_bf16) and K3-fwd (sdf_value_feat_grad_fwd), recorded on one NVIDIA
GPU for the measurement scripts (scripts/trace_kernels_torch.py,
scripts/ablate_k1_k3_torch.py, scripts/ablate_k2_k5_torch.py):

  * "view": Stage2Trainer.render_full of view 0 at 512x512, the default
    Stage2Config at the full SDF width, random weights from the seed and
    chip_smoke.py's ring of 4 cameras (as chip_smoke.py renders it);
  * "step": the loss and backward of one training step of
    iron_tpu_torch.bench's trainer (the synthetic sphere at 256x256, 128x128
    crops), seed + 1, on the crop chip_smoke.py's step takes.

Each entry maps a kernel name to a list of (weights, *arguments) of its
calls, cloned.  Import only where a CUDA device is visible.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main_path_calls(seed: int = 0, res: int = 512) -> dict:
    import torch
    sys.path.insert(0, ROOT)
    from chip_smoke import ring_cameras
    from iron_tpu_torch.bench import bench_trainer
    from iron_tpu_torch.kernels import fused_sdf as K12
    from iron_tpu_torch.kernels import fused_sdf_grad as K3
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer, stage2_loss

    dev = torch.device("cuda")
    clone = lambda a: a.detach().clone() if isinstance(a, torch.Tensor) else a
    out = {}
    targets = ((K12, "coarse_march"), (K12, "sdf_only_bf16"), (K3, "sdf_value_feat_grad_fwd"))
    saved = {name: getattr(mod, name) for mod, name in targets}

    def recording(rec):
        for mod, name in targets:
            def call(w, *a, _fn=saved[name], _calls=rec.setdefault(name, [])):
                _calls.append((w,) + tuple(clone(x) for x in a))
                return _fn(w, *a)
            call.launches = 0   # the wrapper counts its launches on this name
            setattr(mod, name, call)

    try:
        Ks, W2Cs = ring_cameras(4, res)
        images = np.zeros((4, res, res, 3), np.float32)
        tr = Stage2Trainer(Stage2Config(), images, Ks, W2Cs,
                           generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        recording(out.setdefault("view", {}))
        tr.render_full(0)
        for mod, name in targets:
            setattr(mod, name, saved[name])
        tr = bench_trainer("cuda", seed=seed + 1)
        recording(out.setdefault("step", {}))
        # the first crop of run(seed=seed), its loss and backward; no update,
        # so that the recorded weights stay the step's
        g = np.random.default_rng((seed + 1) * 1_000_003)
        cam, gt, gt_mask = tr.crop(int(g.integers(0, 4)), int(g.integers(0, 128)),
                                   int(g.integers(0, 128)))
        eik = torch.rand((128 * 128 // 2, 3), generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev) * 2 - 1
        loss, _ = stage2_loss(tr.params, tr.mat_cfgs, tr.cfg, cam, gt, eik, gt_mask)
        loss.backward()
    finally:
        for mod, name in targets:
            setattr(mod, name, saved[name])
    torch.cuda.synchronize()
    return out
