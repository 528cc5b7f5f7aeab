"""The rank processes of tests/test_torch_dist.py and the configurations both
share.  Run as

    python tests/torch_dist_workers.py RANK WORLD WORKDIR [tp]

A worker reads WORKDIR/inputs.pkl (written by the test: parameter trees,
data, draws and crops as numpy), joins a gloo group of WORLD ranks through
the file WORKDIR/init (60 s timeout), runs every data-parallel case of the
port on its rank on the CPU, one torch thread (with `tp`: the stage-1 step
on a (dp 2, tp 2) mesh of WORLD = 4 ranks), and writes its results to
WORKDIR/rank<RANK>.pkl (tp_rank<RANK>.pkl).  It imports nothing of JAX."""
import os
import pickle
import sys

import numpy as np
import torch

NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, mode="idr", d_in=9, d_out=3, d_hidden=32, n_layers=4,
             multires=4, multires_view=2, squeeze_out=True, skip_in=(2,))
NERF = dict(D=2, W=32, skips=(0,))
# tests/test_dist.py's tiny stage-1 render and schedule, the narrow networks
# and the mask term on (so that the halves of a batch hold other mask sums)
S1 = dict(end_iter=10, warm_up_end=2, anneal_end=5, batch_size=64, mask_weight=0.1)
S1_RENDER = dict(n_samples=8, n_importance=8, n_outside=4, up_sample_steps=2, perturb=1.0)
# the tp step: networks wide enough that the JAX rule splits their hidden
# layers (outputs of 128 or more)
WIDE = dict(d_out=129, d_hidden=128, n_layers=3, skip_in=(), multires=2)
WIDE_COLOR = dict(d_feature=128, mode="idr", d_in=9, d_out=3, d_hidden=128, n_layers=2,
                  multires=2, multires_view=2, squeeze_out=True, skip_in=())
WIDE_NERF = dict(D=2, W=128, skips=(0,), multires=2, multires_view=2)
# the stage-2 step: comp on 16x16 crops, tests/test_dist.py's budgets
PS = 16
S2_SURF = dict(edge_budget=64, edge_side_fallback_budget=16)
S2_TRACE = dict(sphere_tracing_iters=16, dense_iters=8, fallback_budget=64)
# the band render: tests/test_dist.py's configuration (edges off, the
# fallback sweep on every ray, so that a band and the whole frame trace alike)
R2_SURF = dict(edge_budget=64, edge_side_fallback_budget=16, handle_edges=False)
R2_TRACE = dict(sphere_tracing_iters=24, dense_iters=24, fallback_budget=None)


def wide_cfg():
    """The port's stage-1 config of the tp step."""
    from iron_tpu_torch.fields.nerf import NeRFConfig
    from iron_tpu_torch.fields.rendering import RenderingConfig
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.train.stage1 import Stage1Config
    from iron_tpu_torch.volume.integrator import NeuSRenderConfig
    return Stage1Config(sdf=SDFConfig(**WIDE), color=RenderingConfig(**WIDE_COLOR),
                        nerf=NeRFConfig(**WIDE_NERF), render=NeuSRenderConfig(**S1_RENDER),
                        **S1)


def stage1_step_case(mesh, s1: dict, cfg) -> dict:
    """One stage-1 step of make_dp_stage1_step on this rank's rows of the
    global batch and draws of `s1`, Adam over tp_shards (the whole tree when
    tp = 1): the metrics, the whole tree's gradients and parameters after
    the step, Adam's moments gathered over tp, and this rank's Adam-state
    sizes."""
    from iron_tpu_torch.dist.mesh import shard_batch
    from iron_tpu_torch.dist.train import make_dp_stage1_step, tp_dims, tp_shards
    from iron_tpu_torch.train.stage1 import (Stage1Draws, stage1_adam,
                                             stage1_params_from_numpy)
    T = torch.as_tensor
    params = stage1_params_from_numpy(s1["params"], cfg, "cpu")
    shards = tp_shards(params, mesh)
    opt = stage1_adam(shards.values(), "cpu")
    rows = lambda a: shard_batch(T(a), mesh)
    draws = Stage1Draws(img_idx=T(0), px=None, py=None, t_rand=rows(s1["t_rand"]),
                        t_rand_outside=rows(s1["t_rand_outside"]))
    m = make_dp_stage1_step(cfg, mesh)(params, opt, rows(s1["batch"]), s1["step"], draws)
    dims = tp_dims(params, mesh)
    moments = {}
    for (name, q), d in zip(shards.items(), dims.values()):
        for key in ("exp_avg", "exp_avg_sq"):
            t = opt.state[q][key]
            moments[f"{name}.{key}"] = (mesh.all_gather(t, "tp", d) if d is not None
                                        else t).numpy().copy()
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads(params),
            "params": named(params), "moments": moments,
            "adam_numel": sum(t.numel() for st in opt.state.values()
                              for k, t in st.items() if k != "step"),
            "sharded": sorted(n for n, d in dims.items() if d is not None)}


def port_cfgs():
    """(stage-1 step, stage-2 step, stage-2 render) configs of the port."""
    from iron_tpu_torch.fields.nerf import NeRFConfig
    from iron_tpu_torch.fields.rendering import RenderingConfig
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.surface.render import SurfaceRenderConfig
    from iron_tpu_torch.surface.tracer import TracerConfig
    from iron_tpu_torch.train.stage1 import Stage1Config
    from iron_tpu_torch.train.stage2 import Stage2Config
    from iron_tpu_torch.volume.integrator import NeuSRenderConfig
    s1 = Stage1Config(sdf=SDFConfig(**NARROW), color=RenderingConfig(**COLOR),
                      nerf=NeRFConfig(**NERF), render=NeuSRenderConfig(**S1_RENDER), **S1)
    s2 = Stage2Config(renderer_name="comp", patch_size=PS, sdf=SDFConfig(**NARROW),
                      surface=SurfaceRenderConfig(tracer=TracerConfig(**S2_TRACE), **S2_SURF))
    r2 = Stage2Config(renderer_name="ggx", patch_size=PS, sdf=SDFConfig(**NARROW),
                      surface=SurfaceRenderConfig(tracer=TracerConfig(**R2_TRACE), **R2_SURF))
    return s1, s2, r2


def named(params, value=lambda p: p):
    """{name: value(p) as numpy} over a module's parameters."""
    return {n: value(p).detach().cpu().numpy().copy() for n, p in params.named_parameters()}


def grads(params):
    return named(params, lambda p: p.grad if p.grad is not None else torch.zeros_like(p))


def run_cases(mesh, inp: dict) -> dict:
    """Every data-parallel case on this rank; returns its results."""
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.dist.mesh import replicate, shard_batch
    from iron_tpu_torch.dist.train import (host_sharded_views, make_dp_stage1_render,
                                           make_dp_stage1_step, make_dp_stage2_render,
                                           make_dp_stage2_step)
    from iron_tpu_torch.shading.materials import renderer_network_configs
    from iron_tpu_torch.train.checkpoints import params_from_numpy
    from iron_tpu_torch.train.stage1 import (Stage1Draws, init_stage1_params,
                                             stage1_params_from_numpy)
    from iron_tpu_torch.train.stage2 import make_optimizer

    c1, c2, r2 = port_cfgs()
    mat_cfgs = {name: renderer_network_configs(name, d_feature=NARROW["d_out"] - 1)
                for name in ("comp", "ggx")}
    T = torch.as_tensor
    r = mesh.rank
    out = {"rank": r, "size": mesh.size, "shape": dict(mesh.shape)}

    # replicate: parameters and Adam moments drawn differently on each rank
    p = init_stage1_params(c1, torch.Generator().manual_seed(100 + r), "cpu")
    opt = torch.optim.Adam(p.parameters(), lr=1e-3)
    for q in p.parameters():
        q.grad = torch.randn(q.shape, generator=torch.Generator().manual_seed(7 + r))
    opt.step()
    out["before_replicate"] = named(p)
    replicate(p, mesh)
    replicate(opt, mesh)
    out["replicated"] = named(p)
    out["replicated_adam"] = named(p, lambda q: opt.state[q]["exp_avg_sq"])
    out["shard"] = {"x": shard_batch(np.arange(12).reshape(6, 2), mesh),
                    "y": shard_batch(T(np.arange(4.0)), mesh)}

    # the dp stage-1 step on this rank's rows of the global batch and draws
    s1 = inp["s1"]
    params = stage1_params_from_numpy(s1["params"], c1, "cpu")
    opt = torch.optim.Adam(params.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    rows = lambda a: shard_batch(T(a), mesh)
    draws = Stage1Draws(img_idx=T(0), px=None, py=None, t_rand=rows(s1["t_rand"]),
                        t_rand_outside=rows(s1["t_rand_outside"]))
    m = make_dp_stage1_step(c1, mesh)(params, opt, rows(s1["batch"]), s1["step"], draws)
    out["s1"] = {"metrics": {k: float(v) for k, v in m.items()}, "grads": grads(params),
                 "params": named(params)}

    # the tp = 1 reference of the tp step: the wide networks on dp = 2
    out["s1_wide"] = stage1_step_case(mesh, inp["s1_wide"], wide_cfg())

    # the dp stage-2 step: the same crop on every rank, then each rank's own
    s2 = inp["s2"]
    step2 = make_dp_stage2_step(c2, mat_cfgs["comp"], mesh, s2["images"], s2["Ks"], s2["W2Cs"])
    for case, (idx, col, row, eik) in (("same", s2["same"]), ("own", s2["crops"][r])):
        params = params_from_numpy(s2["params"], "cpu", c2.sdf, "comp")
        opt = make_optimizer(c2, params)
        m = step2(params, opt, idx, col, row, T(eik))
        out[f"s2_{case}"] = {"metrics": {k: float(v) for k, v in m.items()},
                             "grads": grads(params), "params": named(params)}

    # per-shard data: rank r holds only view r, local index 0, against the
    # replicated views with global index r
    idx, col, row, eik = s2["crops"][r]
    step_s = make_dp_stage2_step(c2, mat_cfgs["comp"], mesh, per_shard_data=True)
    views = host_sharded_views(s2["images"][r:r + 1], s2["Ks"][r:r + 1], s2["W2Cs"][r:r + 1],
                               mesh)
    res = {}
    for case in ("replicated", "per_shard"):
        params = params_from_numpy(s2["params"], "cpu", c2.sdf, "comp")
        opt = make_optimizer(c2, params)
        m = (step2(params, opt, r, col, row, T(eik)) if case == "replicated"
             else step_s(params, opt, *views, 0, col, row, T(eik)))
        res[case] = {"metrics": {k: float(v) for k, v in m.items()}, "params": named(params)}
    out["per_shard"] = res

    # the dp renders
    rd = inp["render"]
    params = stage1_params_from_numpy(s1["params"], c1, "cpu")
    color, normal = make_dp_stage1_render(c1, mesh)(params, T(rd["rays_o"]), T(rd["rays_d"]))
    out["render1"] = {"color": color.numpy(), "normal": normal.numpy()}
    params = params_from_numpy(rd["params2"], "cpu", r2.sdf, "ggx")
    buf = make_dp_stage2_render(r2, mat_cfgs["ggx"], mesh, rd["H"], rd["W"])(
        params, rd["K"], rd["W2C"])
    out["render2"] = {k: v.numpy() for k, v in buf.items()}

    # per-host image shards of a scene folder
    ds = RayDataset.from_folder(inp["folder"], per_host_shard=True, device="cpu")
    out["fpaths"] = [os.path.basename(f) for f in ds.fpaths]
    return out


def run_tp_cases(mesh, inp: dict) -> dict:
    """The stage-1 step on a (dp 2, tp 2) mesh: this rank's place, the sum
    of the ranks of each of its groups, and its step."""
    group_sums = {axis: float(mesh.all_reduce_sum(torch.tensor([float(mesh.rank)]), axis))
                  for axis in ("dp", "tp", "world")}
    return {"rank": mesh.rank, "dp_rank": mesh.dp_rank, "tp_rank": mesh.tp_rank,
            "shape": dict(mesh.shape), "group_sums": group_sums,
            "s1_wide": stage1_step_case(mesh, inp["s1_wide"], wide_cfg())}


def main(rank: int, world: int, workdir: str, tp: bool = False) -> None:
    import torch.distributed as dist
    from iron_tpu_torch.dist.mesh import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    prefix = "tp_" if tp else ""
    initialize_distributed(backend="gloo", device="cpu",
                           init_method="file://" + os.path.join(workdir, prefix + "init"),
                           rank=rank, world_size=world, timeout=60)
    try:
        out = (run_tp_cases(make_mesh(tp=2, device="cpu"), inp) if tp
               else run_cases(make_mesh(device="cpu"), inp))
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"{prefix}rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4:] == ["tp"])
