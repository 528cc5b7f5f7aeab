#!/usr/bin/env python3
"""SDF sweep throughput of the PyTorch port on one NVIDIA GPU (the
counterpart of scripts/bench_sdf_eval.py): the no-grad evaluators on
262,144 points uniform in [-1, 1]^3 at the full default SDF width (weights
from torch.Generator seed 0).

    python3 scripts/bench_sdf_eval_torch.py

Times the port's f32 sdf_only (cuBLAS, TF32 off), K2 (the bf16 coarse
evaluator), K4 (the 3-pass trace evaluator) and K5 (the f32 full output,
column 0 taken) by CUDA events over back-to-back calls after a warm-up, each
with its max error against the f32 sdf_only.  Prints the card's name and
power limit, then one JSON line per evaluator.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card_line, cuda_ms  # noqa: E402
from iron_tpu_torch import resolve_device  # noqa: E402
from iron_tpu_torch.fields.sdf import SDFConfig, init_sdf, sdf_only  # noqa: E402
from iron_tpu_torch.kernels import make_sdf_fn  # noqa: E402
from iron_tpu_torch.kernels.fused_sdf import make_sdf_only_3pass_fn, make_sdf_only_bf16_fn  # noqa: E402

N_POINTS = 262_144
EVALUATORS = ("f32 sdf_only", "K2 sdf_only_bf16", "K4 sdf_only_3pass", "K5 sdf_full[..., 0]")


def sweep(names=EVALUATORS) -> None:
    """Time the evaluators `names` on the card and print one JSON line each."""
    dev = resolve_device("cuda")
    net = init_sdf(SDFConfig(), torch.Generator(device=dev).manual_seed(0), dev)
    x = torch.rand((N_POINTS, 3), generator=torch.Generator(device=dev).manual_seed(1),
                   device=dev) * 2 - 1
    full = make_sdf_fn(net)
    evaluators = dict(zip(EVALUATORS, (lambda p: sdf_only(net, p), make_sdf_only_bf16_fn(net),
                                       make_sdf_only_3pass_fn(net), lambda p: full(p)[..., 0])))
    with torch.no_grad():
        ref = sdf_only(net, x)
        for name in names:
            fn = evaluators[name]
            ms = cuda_ms(lambda: fn(x), iters=20, warmup=3)
            err = float((fn(x) - ref).abs().max())
            print(json.dumps({"evaluator": name, "points": N_POINTS, "ms": ms,
                              "mpts_per_s": N_POINTS / ms / 1e3, "max_abs_err_vs_f32": err}),
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible: this bench runs only on a GPU", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    sweep()
    return 0


if __name__ == "__main__":
    sys.exit(main())
