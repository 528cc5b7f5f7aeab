"""One step of each data-parallel step at tiny shapes, on every rank
(counterpart of __graft_entry__.py's dryrun_multichip):

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m iron_tpu_torch.dist.dryrun [--device cpu]

The mesh is (N / 2, 2) when N is even, as the JAX dry run lays it: tp = 2
shards stage 1's hidden dims (its Adam holds the rank's tp slices); else
(N, 1).  Runs the stage-1 step, the dp stage-2 step and the per-shard-data
stage-2 step once each (stage 2 over dp, replicated over tp), checks that
every loss is finite and that every rank holds the same parameters bit for
bit after each step (the stage-1 step leaves the whole tree, all-gathered
over tp, on every rank), and exits non-zero on any failure.  NCCL on CUDA
(one card a rank), gloo with --device cpu.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _same_on_every_rank(mesh, params, what: str) -> None:
    """Raise unless every rank holds rank 0's parameters bit for bit."""
    from iron_tpu_torch.dist.mesh import replicate
    mine = torch.cat([p.detach().reshape(-1) for p in params.parameters()])
    ref = replicate(mine.clone(), mesh)
    if not torch.equal(mine, ref):
        raise AssertionError(f"{what}: rank {mesh.rank}'s parameters differ from rank 0's")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from iron_tpu_torch.dist.mesh import initialize_distributed, make_mesh, replicate
    from iron_tpu_torch.dist.train import (draw_dp_stage1, host_sharded_views,
                                           make_dp_stage1_step, make_dp_stage2_step, tp_shards)
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.surface.render import SurfaceRenderConfig
    from iron_tpu_torch.train.stage1 import Stage1Config, init_stage1_params, stage1_adam
    from iron_tpu_torch.train.stage2 import Stage2Config, init_stage2_params, make_optimizer
    from iron_tpu_torch.volume.integrator import NeuSRenderConfig

    dev = initialize_distributed(device=args.device)
    try:
        world = dist.get_world_size() if dist.is_initialized() else 1
        mesh = make_mesh(tp=2 if world % 2 == 0 else 1, device=dev)
        dp, r = mesh.shape["dp"], mesh.dp_rank
        g = np.random.default_rng(0)

        # ---- stage 1: the global batch of 8 rays a rank split over dp ----
        cfg1 = Stage1Config(end_iter=8, warm_up_end=2, anneal_end=4, batch_size=8 * dp,
                            render=NeuSRenderConfig(n_samples=8, n_importance=8, n_outside=4,
                                                    up_sample_steps=2, perturb=1.0))
        params1 = init_stage1_params(cfg1, torch.Generator(device=dev).manual_seed(mesh.rank),
                                     dev)
        replicate(params1, mesh)
        opt1 = stage1_adam(tp_shards(params1, mesh).values(), dev)
        H = W = 32
        images = g.uniform(size=(2, H, W, 3)).astype(np.float32)
        K = np.eye(4, dtype=np.float32)
        K[0, 0] = K[1, 1] = 40.0
        K[0, 2] = K[1, 2] = 16.0
        W2C = np.eye(4, dtype=np.float32)
        W2C[:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
        W2C[2, 3] = 3.0
        Ks, W2Cs = np.stack([K, K]), np.stack([W2C, W2C])
        ds = RayDataset.from_arrays(images, Ks, W2Cs, device=dev)
        batch, draws = draw_dp_stage1(cfg1, ds, torch.Generator(device=dev).manual_seed(1), mesh)
        m1 = make_dp_stage1_step(cfg1, mesh)(params1, opt1, batch, 1, draws)
        if not np.isfinite(float(m1["loss"])):
            raise AssertionError(f"stage 1: loss {float(m1['loss'])}")
        _same_on_every_rank(mesh, params1, "stage 1")

        # ---- stage 2: one 16x16 crop a dp rank, the views replicated ----
        cfg2 = Stage2Config(renderer_name="comp", patch_size=16,
                            surface=SurfaceRenderConfig(edge_budget=32), sdf=SDFConfig())
        params2, mat_cfgs = init_stage2_params(cfg2, torch.Generator(device=dev).manual_seed(2),
                                               dev)
        replicate(params2, mesh)
        opt2 = make_optimizer(cfg2, params2)
        uls = g.integers(0, H - 16, size=(2, dp))
        eik_gen = torch.Generator(device=dev).manual_seed(3 + r)
        eik = lambda: torch.rand((16 * 16 // 2, 3), generator=eik_gen, device=dev) * 2 - 1
        step2 = make_dp_stage2_step(cfg2, mat_cfgs, mesh, images, Ks, W2Cs)
        m2 = step2(params2, opt2, 0, int(uls[0, r]), int(uls[1, r]), eik())
        if not np.isfinite(float(m2["loss"])):
            raise AssertionError(f"stage 2: loss {float(m2['loss'])}")
        _same_on_every_rank(mesh, params2, "stage 2")

        # ---- stage 2 with per-shard data: each rank holds its own view ----
        views = host_sharded_views(images[:1], Ks[:1], W2Cs[:1], mesh)
        step2s = make_dp_stage2_step(cfg2, mat_cfgs, mesh, per_shard_data=True)
        m2s = step2s(params2, opt2, *views, 0, int(uls[0, r]), int(uls[1, r]),
                     eik())
        if not np.isfinite(float(m2s["loss"])):
            raise AssertionError(f"stage 2 per-shard data: loss {float(m2s['loss'])}")
        _same_on_every_rank(mesh, params2, "stage 2 per-shard data")
        print(f"dryrun rank {mesh.rank} of {mesh.size} (dp {dp}, tp {mesh.shape['tp']}) on {dev} "
              f"({dist.get_backend() if dist.is_initialized() else 'no group'}): stage 1 loss "
              f"{float(m1['loss']):.6f}, stage 2 {float(m2['loss']):.6f}, per-shard data "
              f"{float(m2s['loss']):.6f}, parameters equal on every rank", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
