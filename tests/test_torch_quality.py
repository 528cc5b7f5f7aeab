"""The port's quality path (iron_tpu_torch/eval/e2e_validation.py,
psnr_decomposition.py, relight_eval.py) against the JAX package's scripts
(scripts/e2e_validation.py, psnr_decomposition.py, relight_eval.py) on the
CPU, at small sizes:

  * the flags of each module against its script's, letter for letter;
  * the held-out split and both configurations that e2e_validation builds
    (scripts/e2e_validation.py:96-102, 121-150), field by field;
  * the material statistics on transplanted ggx parameters, against the
    same sums through the JAX package's sdf_value_feat_grad and
    get_materials, to 1e-4 relative;
  * the chamfer trajectory of a run directory the JAX package wrote,
    against its extract_geometry, largest_component and chamfer_distance
    at mesh resolution 32, to 1e-6 relative;
  * the decomposition's renders (D of the sphere on the ring and of the
    torus on the hemisphere; B and A on transplanted parameters) against
    the JAX package's render_camera, with test_torch_render.py's holds: the
    hit and edge masks identical, colour within 1e-4 + 1e-4 relative on
    the covered pixels (the two tracers stop at the same 5e-5 threshold
    along different f32 step sequences), and the report's PSNRs within
    0.01 dB and SSIM within 1e-5 of the JAX metrics on the JAX renders;
  * relight_eval's per-view PSNR against the same steps through the JAX
    package's export_assets, mesh_scene_np, render_view_np and
    render_mesh_flash on one checkpoint, to 0.01 dB;
  * a run of the three entry points in a process where jax, the JAX
    package, optax, cv2 and PIL cannot be imported: e2e_validation with 2
    + 2 steps at 32x32, 8 + 8 samples and mesh resolution 32 (narrow
    networks, a checkpoint every 2 steps), resumed by a second call with 4
    + 4 steps, then the decomposition and the relighting on its run
    directory.

Every test reaching the JAX package's native library builds it first
through torch_port_helpers.build_jax_native_library, which cannot
interleave with another worker's build."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_port_helpers import build_jax_native_library, one_torch_thread  # noqa: F401
import jax
import jax.numpy as jnp

from iron_tpu.cli.train_surface import export_assets as j_export_assets
from iron_tpu.core.camera import make_camera as j_make_camera
from iron_tpu.data import synthetic as jsyn
from iron_tpu.eval import independent_gt as jgt
from iron_tpu.eval import metrics as jmetrics
from iron_tpu.eval.relight import render_mesh_flash as j_render_mesh_flash
from iron_tpu.export import materials as jmaterials
from iron_tpu.export.mesh import extract_geometry as j_extract_geometry
from iron_tpu.export.mesh import largest_component as j_largest_component
from iron_tpu.fields import sdf as jsdf
from iron_tpu.shading.materials import get_materials as j_get_materials
from iron_tpu.shading.materials import renderer_network_configs as j_net_cfgs
from iron_tpu.surface.render import SurfaceRenderConfig as JSurf
from iron_tpu.surface.render import render_camera as j_render
from iron_tpu.surface.render import scale_config_for_resolution as j_scale_cfg
from iron_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from iron_tpu.train.stage1 import Stage1Config as JStage1Config
from iron_tpu.train.stage1 import init_stage1_params as j_init_stage1
from iron_tpu.train.stage2 import Stage2Config as JStage2Config
from iron_tpu.train.stage2 import build_stage2_fns as j_build_stage2_fns
from iron_tpu.train.stage2 import init_stage2_params as j_init_stage2
from iron_tpu.volume.integrator import NeuSRenderConfig as JNeuSRender

from iron_tpu_torch.core.camera import make_camera
from iron_tpu_torch.eval import e2e_validation, psnr_decomposition, relight_eval
from iron_tpu_torch.eval.independent_gt import render_independent_dataset
from iron_tpu_torch.export import materials as tmaterials
from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.shading.materials import renderer_network_configs
from iron_tpu_torch.surface.render import SurfaceRenderConfig, scale_config_for_resolution
from iron_tpu_torch.train.checkpoints import params_from_numpy
from iron_tpu_torch.train.stage2 import Stage2Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
# the material bake of the relighting tests: 1 x 20,000 samples into 128^2
# atlases instead of 5 x 500,000 into 1024^2 (CPU time), in both packages
SMALL_BAKE = dict(n_rounds=1, samples_per_round=20_000, texture_H=128, texture_W=128)


# ---------------------------------------------------------------------------
# (1) flags, split and configurations
# ---------------------------------------------------------------------------

def _script_flags(name: str) -> dict:
    """{option: {default, type, choices, action, required}} of the
    add_argument calls in scripts/<name>.py."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", name + ".py")).read())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            flags[node.args[0].value] = {
                "default": ast.literal_eval(kw["default"]) if "default" in kw else None,
                "type": kw["type"].id if "type" in kw else None,
                "choices": ast.literal_eval(kw["choices"]) if "choices" in kw else None,
                "action": ast.literal_eval(kw["action"]) if "action" in kw else None,
                "required": ast.literal_eval(kw["required"]) if "required" in kw else False}
    return flags


@pytest.mark.parametrize("module", [e2e_validation, psnr_decomposition, relight_eval],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_flags_are_the_scripts(module):
    """Each module takes its JAX script's flags with their defaults, types,
    choices and actions, and one more: --device."""
    want = _script_flags(module.__name__.split(".")[-1])
    actions = {a.option_strings[-1]: a for a in module.arg_parser()._actions
               if a.option_strings and a.dest != "help"}
    assert set(actions) == set(want) | {"--device"}
    assert actions["--device"].default == "cuda"
    for flag, w in want.items():
        a = actions[flag]
        if w["action"] == "store_true":
            assert a.const is True and a.default is False, flag
            continue
        assert a.default == w["default"], flag
        assert (a.type.__name__ if a.type else None) == w["type"], flag
        assert (list(a.choices) if a.choices else None) == w["choices"], flag
        assert a.required == w["required"], flag


def _assert_same_fields(port, ref, dropped=(), path=""):
    """Every field of the JAX dataclass `ref` equal in the port's `port`
    (nested dataclasses field by field), but the `dropped` names, which the
    port leaves out; the port has no field of its own."""
    names = {f.name for f in dataclasses.fields(ref)}
    assert {f.name for f in dataclasses.fields(port)} == names - set(dropped), path
    for name in sorted(names - set(dropped)):
        a, b = getattr(port, name), getattr(ref, name)
        if dataclasses.is_dataclass(b):
            _assert_same_fields(a, b, (), f"{path}.{name}")
        elif isinstance(b, (tuple, list)):
            assert tuple(a) == tuple(b), f"{path}.{name}"
        else:
            assert a == b, (f"{path}.{name}", a, b)


@pytest.mark.parametrize("argv", [
    [], ["--fast"], ["--rig", "hemisphere", "--scene", "torus"],
    ["--rig", "hemisphere", "--fast", "--stage1_iters", "9"],
    ["--scene", "blobby", "--rig", "ring", "--res", "256", "--independent_gt",
     "--stage1_iters", "14000", "--stage2_iters", "5000", "--n_samples", "64",
     "--n_importance", "64", "--silhouette_weight", "0.3"]])
def test_split_and_configs_are_the_scripts(argv):
    """The held-out split and both configurations, field by field against
    the JAX package's configurations built from the same arguments as
    scripts/e2e_validation.py:96-102 and 121-150 build them (the JAX
    Stage1Config's upsample_precision and core_precision, which nothing in
    the port reads, left out)."""
    args = e2e_validation.parse_args(argv)
    if "--fast" in argv:
        assert (args.stage1_iters, args.stage2_iters, args.res) == (300, 150, 64)
    n = 14
    test_ref = [n // 3, (2 * n) // 3] if args.rig == "hemisphere" else [n - 2, n - 1]
    test_idx, train_idx = e2e_validation.heldout_split(args.rig)
    assert test_idx == test_ref
    assert train_idx == [i for i in range(n) if i not in test_ref]
    assert e2e_validation.rig_kwargs(args.scene, args.rig) == (
        {"pole": "y"} if (args.rig == "hemisphere" and args.scene == "torus") else None)

    s1_ref = JStage1Config(
        end_iter=args.stage1_iters, warm_up_end=max(args.stage1_iters // 20, 10),
        anneal_end=args.stage1_iters // 2, batch_size=512,
        sdf=jsdf.SDFConfig(bias=0.5), mask_weight=0.1,
        render=JNeuSRender(n_samples=args.n_samples, n_importance=args.n_importance,
                           n_outside=0, up_sample_steps=4, perturb=1.0))
    _assert_same_fields(e2e_validation.stage1_config(args), s1_ref,
                        dropped=("upsample_precision", "core_precision"))
    s2_ref = JStage2Config(renderer_name="ggx", patch_size=min(args.res, 128),
                           num_iters=args.stage2_iters,
                           silhouette_weight=args.silhouette_weight,
                           surface=JSurf(edge_budget=1024), save_freq=5000)
    _assert_same_fields(e2e_validation.stage2_config(args), s2_ref)
    # the decomposition's configuration (scripts/psnr_decomposition.py:87-88)
    # and the relighting's (scripts/relight_eval.py:75) keep the defaults
    _assert_same_fields(Stage2Config(renderer_name="ggx",
                                     surface=SurfaceRenderConfig(edge_budget=1024)),
                        JStage2Config(renderer_name="ggx", surface=JSurf(edge_budget=1024)))


# ---------------------------------------------------------------------------
# shared: transplanted ggx parameters at a narrow SDF
# ---------------------------------------------------------------------------

JCFG = JStage2Config(renderer_name="ggx", sdf=jsdf.SDFConfig(**NARROW),
                     surface=JSurf(edge_budget=1024))
TCFG = Stage2Config(renderer_name="ggx", sdf=SDFConfig(**NARROW),
                    surface=SurfaceRenderConfig(edge_budget=1024))


@pytest.fixture(scope="module")
def ggx_params():
    """(JAX ggx parameters at the narrow SDF as numpy, their material
    configs): the geometric-init sphere of radius ~0.5, the light raised to
    a trained run's ~78 and the roughness to its ~0.2 (the last layer's bias
    + 1.8: 0.1 (x + 0.1) + 0.01).  At the initial ~0.02 GGX's peak turns the
    two tracers' root differences (under the 5e-5 threshold) into colour
    differences of 1e-3."""
    params, mats = j_init_stage2(jax.random.PRNGKey(5), JCFG)
    params = to_np(params)
    params["materials"]["point_light_network"]["light"] = np.asarray(77.84, np.float32)
    last = params["materials"]["specular_roughness_network"]["layers"][-1]
    last["b"] = last["b"] + np.float32(1.8)
    return params, mats


# ---------------------------------------------------------------------------
# (2) material statistics
# ---------------------------------------------------------------------------

def _jax_material_stats(params, mat_cfgs, verts, light_rec):
    """scripts/e2e_validation.py:219-249 through the JAX package (the
    queries jitted, with the parameters as arguments)."""
    d_gt, s_gt, r_gt, light_gt = np.asarray([0.6, 0.3, 0.2]), np.asarray([0.3] * 3), 0.2, 30.0
    surf = jnp.asarray(verts[np.random.default_rng(0).choice(
        len(verts), size=min(4096, len(verts)), replace=False)], jnp.float32)

    @jax.jit
    def query(params, surf):
        _, feat, grad = jsdf.sdf_value_feat_grad(params["sdf"], surf, JCFG.sdf)
        nrm = grad / (jnp.linalg.norm(grad, axis=-1, keepdims=True) + 1e-10)
        return j_get_materials(params["materials"], mat_cfgs, surf, nrm, feat)

    mats = query(params, surf)
    d = np.asarray(mats["diffuse_albedo"])
    s = np.asarray(mats["specular_albedo"])
    r = np.asarray(mats["specular_roughness"])
    d_mean, s_mean, r_mean = d.mean(0), s.mean(0), float(r.mean())
    rel = lambda a, b: float(np.mean(np.abs(a - b) / np.clip(np.abs(b), 1e-9, None)))
    chroma = lambda v: v / max(np.sum(v), 1e-9)
    return {"diffuse_albedo_mean": d_mean.tolist(), "specular_albedo_mean": s_mean.tolist(),
            "roughness_mean": r_mean, "roughness_std": float(r.std()),
            "diffuse_albedo_spatial_std": float(d.std(0).mean()),
            "roughness_abs_err": abs(r_mean - r_gt),
            "light_diffuse_product_rel_err": rel(light_rec * d_mean, light_gt * d_gt),
            "light_specular_product_rel_err": rel(light_rec * s_mean, light_gt * s_gt),
            "diffuse_chroma_l1": float(np.abs(chroma(d_mean) - chroma(d_gt)).sum()),
            "diffuse_albedo_rel_err": rel(d_mean, d_gt),
            "specular_albedo_rel_err": rel(s_mean, s_gt)}


@pytest.mark.parametrize("n_verts", [6000, 700])
def test_material_stats_match_jax(ggx_params, n_verts):
    """material_stats on transplanted ggx parameters (4,096 of 6,000 surface
    points drawn, or all 700) against the same sums through the JAX
    package, every value to 1e-4 relative."""
    params, mats = ggx_params
    g = np.random.default_rng(n_verts)
    v = g.normal(size=(n_verts, 3))
    verts = (0.5 * v / np.linalg.norm(v, axis=-1, keepdims=True)
             + 0.01 * g.normal(size=(n_verts, 3))).astype(np.float32)
    light = float(params["materials"]["point_light_network"]["light"])
    got = e2e_validation.material_stats(params_from_numpy(params, "cpu", TCFG.sdf, "ggx"),
                                        renderer_network_configs("ggx", d_feature=32),
                                        verts, light, "cpu")
    ref = _jax_material_stats(params, mats, verts, light)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=0, err_msg=k)


# ---------------------------------------------------------------------------
# (3) the chamfer trajectory of a run directory the JAX package wrote
# ---------------------------------------------------------------------------

def test_chamfer_trajectory_of_a_jax_run_matches_jax(tmp_path):
    """A run directory written by the JAX package's save_checkpoint
    (stage-1 checkpoints at steps 5,000 and 10,000 with optax's Adam state,
    stage-2 checkpoints at steps 5,000 and 10,000 and a ckpt_best.pkl, which
    the trajectory skips), scored by chamfer_trajectory at mesh resolution
    32 against the blobby scene's mesh, and by the JAX package's
    extract_geometry, largest_component and chamfer_distance: the JAX
    script's rows (the newest stage-1 checkpoint as "stage1_final", each
    stage-2 one) and the older stage-1 checkpoint's row, which the JAX
    script leaves out; the same vertex counts, every chamfer to 1e-6
    relative."""
    import optax
    build_jax_native_library()
    jcfg = jsdf.SDFConfig(**NARROW)
    trees = {b: to_np(jsdf.init_sdf(jax.random.PRNGKey(k), dataclasses.replace(jcfg, bias=b)))
             for k, b in ((1, 0.45), (2, 0.5), (3, 0.55), (4, 0.4))}
    s1 = to_np(j_init_stage1(jax.random.PRNGKey(0), JStage1Config(sdf=jcfg)))
    opt = to_np(optax.adam(lambda c: 1e-3).init(s1))
    run = str(tmp_path)
    for step, b in ((5000, 0.4), (10000, 0.45)):
        j_save_checkpoint(os.path.join(run, "stage1"), step, {**s1, "sdf": trees[b]}, opt,
                          extra={"note": "jax"})
    for step, b in ((5000, 0.5), (10000, 0.55)):
        j_save_checkpoint(os.path.join(run, "stage2"), step,
                          {"sdf": trees[b], "materials": {}})
    os.replace(os.path.join(run, "stage2", "ckpt_0005000.pkl"),
               os.path.join(run, "stage2", "ckpt_best.pkl"))
    j_save_checkpoint(os.path.join(run, "stage2"), 5000, {"sdf": trees[0.5], "materials": {}})

    gv, gt = j_largest_component(*jgt.mesh_scene_np(jgt.blobby_sdf_np(), resolution=48))
    got = e2e_validation.chamfer_trajectory(run, SDFConfig(**NARROW), gv, gt, "cpu",
                                            resolution=32)

    def ref_row(tree):
        v, t = j_extract_geometry(lambda p: -jsdf.sdf_only(tree, p, jcfg), resolution=32)
        v, t = j_largest_component(v, t)
        return {"verts": int(len(v)), "chamfer": jmetrics.chamfer_distance(v, t, gv, gt)}

    ref = {"stage1_5000": ref_row(trees[0.4]), "stage1_final": ref_row(trees[0.45]),
           "stage2_5000": ref_row(trees[0.5]), "stage2_10000": ref_row(trees[0.55])}
    assert list(got) == list(ref)
    for k in ref:
        assert got[k]["verts"] == ref[k]["verts"] > 100, k
        np.testing.assert_allclose(got[k]["chamfer"], ref[k]["chamfer"], rtol=1e-6, err_msg=k)
    assert len({round(r["chamfer"], 6) for r in ref.values()}) == 4


# ---------------------------------------------------------------------------
# (4) the PSNR decomposition
# ---------------------------------------------------------------------------

def _jax_scene(scene):
    return {"sphere": jsyn.sphere_scene, "torus": jsyn.torus_scene,
            "blobby": jsyn.blobby_scene}[scene]()


@pytest.mark.parametrize("scene,rig,configs", [("sphere", "ring", "DBA"),
                                               ("torus", "hemisphere", "D")])
def test_decomposition_matches_jax_render_camera(tmp_path, ggx_params, scene, rig, configs):
    """decompose() at 32x32 on the independent renderer's views (its GT
    mesh at 64) and a checkpoint of transplanted ggx parameters: each
    configuration's render of each held-out view against the JAX package's
    render_camera of the same evaluators (D: the scene's analytic SDF and
    GT shading; B: the learned SDF, GT shading; A: both learned), with the
    holds of the module's docstring, and the report's PSNR, masked PSNR and
    SSIM against the JAX package's metrics on the JAX renders."""
    params, mats = ggx_params
    res = 32
    run = str(tmp_path)
    j_save_checkpoint(os.path.join(run, "stage2"), 7, params)
    kw = e2e_validation.rig_kwargs(scene, rig)
    data = render_independent_dataset(scene, n_views=14, H=res, W=res, light=30.0, rig=rig,
                                      rig_kwargs=kw, mesh_resolution=64)
    args = psnr_decomposition.parse_args(["--run_dir", run, "--scene", scene, "--rig", rig,
                                          "--res", str(res), "--ckpt", "final",
                                          "--device", "cpu"])
    report = psnr_decomposition.decompose(args, TCFG, "cpu", data=data)
    assert report["ckpt_step"] == 7 and report["device"] == "cpu"
    assert report["test_views"] == e2e_validation.heldout_split(rig)[0]
    with open(os.path.join(run, "psnr_decomposition.json")) as fh:
        assert json.load(fh) == report

    tp = params_from_numpy(params, "cpu", TCFG.sdf, "ggx")
    surf = scale_config_for_resolution(TCFG.surface, res, res)
    fns = psnr_decomposition.render_fns(tp, TCFG, scene, rig, 30.0, surf, "cpu")
    jsurf = j_scale_cfg(JCFG.surface, res, res)
    gt_sdf, gt_sdf_all = _jax_scene(scene)
    shade = jsyn.make_ggx_shade_fn(30.0)
    f = j_build_stage2_fns(jax.tree_util.tree_map(jnp.asarray, params), mats, JCFG)
    learned = dict(trace_sdf_fn=f["trace_sdf_fn"], trace_sdf_all_fn=f["trace_sdf_all_fn"],
                   coarse_sdf_fn=f["coarse_sdf_fn"], coarse_march_fn=f["coarse_march_fn"])
    jfns = {"D": lambda cam: j_render(gt_sdf, gt_sdf_all, shade, cam, jsurf),
            "B": lambda cam: j_render(f["sdf_fn"], f["sdf_all_fn"], shade, cam, jsurf,
                                      **learned),
            "A": lambda cam: j_render(f["sdf_fn"], f["sdf_all_fn"], f["shade_fn"], cam, jsurf,
                                      **learned)}
    for name in configs:
        jfn = jax.jit(jfns[name])
        psnrs, psnrs_m, ssims = [], [], []
        for ti in report["test_views"]:
            K, W2C = data["Ks"][ti], data["W2Cs"][ti]
            with torch.no_grad():
                got = {k: v.numpy() for k, v in fns[name](make_camera(K, W2C, res, res,
                                                                      device="cpu")).items()
                       if isinstance(v, torch.Tensor)}
            ref = {k: np.asarray(v) for k, v in jfn(j_make_camera(K, W2C, res, res)).items()}
            for k in ("hit_mask", "edge_mask", "convergent_mask"):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=(name, ti, k))
            m = ref["hit_mask"] | ref["edge_mask"]
            assert m.sum() > 50, (name, ti)
            np.testing.assert_allclose(got["color"][m], ref["color"][m], atol=1e-4, rtol=1e-4,
                                       err_msg=(name, ti))
            pred = np.clip(ref["color"], 0, 1)
            gt_img = np.clip(data["images"][ti], 0, 1)
            gmask = data["masks"][ti][..., 0] > 0.5
            psnrs.append(jmetrics.psnr_np(pred, gt_img))
            ssims.append(jmetrics.ssim_np(pred, gt_img))
            psnrs_m.append(-10.0 * np.log10(np.mean((pred[gmask] - gt_img[gmask]) ** 2)
                                            + 1e-12))
        row = report["configs"][name]
        assert abs(row["psnr"] - np.mean(psnrs)) <= 0.01, (name, row, psnrs)
        assert abs(row["psnr_in_mask"] - np.mean(psnrs_m)) <= 0.01, (name, row, psnrs_m)
        assert abs(row["ssim"] - np.mean(ssims)) <= 1e-5, (name, row, ssims)
    c = report["configs"]
    assert report["attribution_db"] == {
        "convention_floor_psnr": c["D"]["psnr"],
        "geometry_cost_db": c["D"]["psnr"] - c["B"]["psnr"],
        "material_cost_db": c["B"]["psnr"] - c["A"]["psnr"]}


# ---------------------------------------------------------------------------
# (5) the relighting eval
# ---------------------------------------------------------------------------

def test_relight_eval_matches_jax(tmp_path, monkeypatch, ggx_params):
    """relight() on one checkpoint of transplanted ggx parameters (the
    export at 32, the GT mesh at 64, 32x32 views, the small bake in both
    packages) against the same steps through the JAX package: its
    export_assets on the same parameters, ring_cameras(5), mesh_scene_np,
    render_view_np and render_mesh_flash at light_rec x 60 / 30: every
    view's PSNR to 0.01 dB."""
    import functools
    build_jax_native_library()
    monkeypatch.setattr(tmaterials, "export_materials",
                        functools.partial(tmaterials.export_materials, **SMALL_BAKE))
    monkeypatch.setattr(jmaterials, "export_materials",
                        functools.partial(jmaterials.export_materials, **SMALL_BAKE))
    params, mats = ggx_params
    res, mesh_res = 32, 64
    run = str(tmp_path / "run")
    j_save_checkpoint(os.path.join(run, "stage2"), 7, params)
    args = relight_eval.parse_args(["--run_dir", run, "--scene", "sphere", "--res", str(res),
                                    "--export_res", "32", "--device", "cpu"])
    report = relight_eval.relight(args, TCFG, "cpu", gt_mesh_resolution=mesh_res)
    light = float(params["materials"]["point_light_network"]["light"])
    assert report["light_recovered"] == pytest.approx(light, rel=1e-7)
    assert report["ckpt_step"] == 7 and report["device"] == "cpu"
    assert os.path.exists(os.path.join(run, "relight_mosaic.png"))

    export_dir = str(tmp_path / "jax_export")
    trainer = SimpleNamespace(params=jax.tree_util.tree_map(jnp.asarray, params), cfg=JCFG,
                              mat_cfgs=j_net_cfgs("ggx", d_feature=32))
    j_export_assets(trainer, export_dir, resolution=32)
    _, Ks, W2Cs = jsyn.ring_cameras(5, H=res, W=res)
    sdf_np = jgt.SCENES_NP["sphere"]()
    gv, gt = jgt.mesh_scene_np(sdf_np, resolution=mesh_res)
    ref = []
    for vi in (2, 4):
        g = jgt.render_view_np(gv, gt, sdf_np, Ks[vi], W2Cs[vi], res, res, 60.0)
        pred = j_render_mesh_flash(os.path.join(export_dir, "mesh.obj"), export_dir,
                                   j_make_camera(Ks[vi], W2Cs[vi], res, res), light=light * 2)
        ref.append(jmetrics.psnr_np(np.clip(pred["color"], 0, 1), np.clip(g["color"], 0, 1)))
    assert 5 < min(ref)
    np.testing.assert_allclose(report["per_view"], ref, atol=0.01, rtol=0)
    assert report["relight_psnr"] == pytest.approx(float(np.mean(report["per_view"])))


# ---------------------------------------------------------------------------
# (6) the three entry points without JAX, OpenCV or PIL
# ---------------------------------------------------------------------------

_RUN_WITHOUT_JAX = r"""
import dataclasses, functools, json, sys
for m in ("jax", "iron_tpu", "optax", "orbax", "cv2", "PIL"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
from iron_tpu_torch.eval import e2e_validation as E, psnr_decomposition as P, relight_eval as R
from iron_tpu_torch.export import materials as tmat
from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.train.stage1 import STAGE1_COLOR
run_dir = sys.argv[1]
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
tmat.export_materials = functools.partial(tmat.export_materials, **json.loads(sys.argv[2]))
out = {}
for call, it in enumerate((2, 4, 4)):
    args = E.parse_args(["--out_dir", run_dir, "--scene", "blobby", "--independent_gt",
                         "--silhouette_weight", "0.3", "--res", "32", "--n_samples", "8",
                         "--n_importance", "8", "--stage1_iters", str(it),
                         "--stage2_iters", str(it), "--device", "cpu"])
    s1 = dataclasses.replace(E.stage1_config(args), save_freq=3,
                             sdf=SDFConfig(bias=0.5, **NARROW),
                             color=dataclasses.replace(STAGE1_COLOR, d_feature=32, d_hidden=32,
                                                       n_layers=4, skip_in=(2,)))
    s2 = dataclasses.replace(E.stage2_config(args), save_freq=2, sdf=SDFConfig(**NARROW))
    out[f"e2e_{call}"] = E.run(args, s1, s2, "cpu", mesh_resolution=32, gt_mesh_resolution=64)
cfg = dataclasses.replace(P.Stage2Config(renderer_name="ggx"), sdf=SDFConfig(**NARROW))
out["decomposition"] = P.decompose(P.parse_args(["--run_dir", run_dir, "--scene", "blobby",
                                                 "--res", "32", "--device", "cpu"]), cfg, "cpu",
                                   gt_mesh_resolution=64)
out["relight"] = R.relight(R.parse_args(["--run_dir", run_dir, "--scene", "blobby", "--res",
                                         "32", "--export_res", "32", "--device", "cpu"]),
                           cfg, "cpu", gt_mesh_resolution=64)
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "iron_tpu", "optax", "orbax", "cv2", "PIL")]
assert not bad, bad
print("REPORTS " + json.dumps(out))
"""


def _finite(tree) -> bool:
    if isinstance(tree, dict):
        return all(_finite(v) for v in tree.values())
    if isinstance(tree, list):
        return all(_finite(v) for v in tree)
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return bool(np.isfinite(tree))
    return True


def test_quality_path_runs_and_resumes_without_jax_opencv_or_pil(tmp_path):
    """The three entry points in a process where jax, the JAX package,
    optax, orbax, cv2 and PIL cannot be imported (the card's machine has
    none of them): e2e_validation on the blobby scene with the independent
    renderer and the silhouette term, 2 + 2 steps at 32x32, 8 + 8 samples,
    mesh resolution 32 (narrow networks; a checkpoint every 3 stage-1 and 2
    stage-2 steps), then a second call with 4 + 4 steps that resumes both
    stages at step 2 from the first call's checkpoints (stage 1's written at
    its end), then a third call with 4 + 4 steps, which trains nothing and
    reports stage 1's record of the second call; then the decomposition and
    the relighting on its run directory.  Each report.json has the top-level keys of the
    JAX package's results/quality_blobby_r5_sil.json and `device`, but
    `best` (written only once a 5,000-step validation ran); every number is
    finite but best_step and best_heldout_psnr, null as in the JAX script;
    the decomposition and relighting reports have the JAX keys and
    `device`."""
    run = str(tmp_path / "run")
    out = subprocess.run([sys.executable, "-c", _RUN_WITHOUT_JAX, run, json.dumps(SMALL_BAKE)],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    reports = json.loads(out.stdout.split("REPORTS ", 1)[1])
    with open(os.path.join(REPO, "results", "quality_blobby_r5_sil.json")) as fh:
        jax_keys = set(json.load(fh))
    for call, it in enumerate((2, 4, 4)):
        rep = reports[f"e2e_{call}"]
        assert set(rep) == (jax_keys - {"best"}) | {"device"}, set(rep) ^ jax_keys
        assert rep["device"] == "cpu" and rep["gt_source"] == "independent"
        assert rep["best_step"] is None and rep["best_heldout_psnr"] is None
        assert rep["val_history"] == []
        assert _finite({k: v for k, v in rep.items()
                        if k not in ("best_step", "best_heldout_psnr")})
        assert (rep["stage1_iters"], rep["stage2_iters"]) == (it, it)
    first, second, third = (reports[f"e2e_{c}"] for c in range(3))
    assert first["stage1"]["resumed_at"] == 0 and second["stage1"]["resumed_at"] == 2
    assert "[stage2] resumed at 2" in out.stdout and "[stage2] resumed at 4" in out.stdout
    assert third["stage1"] == {**second["stage1"], "resumed_at": 4}
    assert "loss" in third["stage1"] and "loss" not in third["stage2"]
    for rep in (second, third):
        assert list(rep["chamfer_trajectory"]) == ["stage1_2", "stage1_3", "stage1_final",
                                                   "stage2_2", "stage2_4"]
    assert second["chamfer_trajectory"] == third["chamfer_trajectory"]
    assert sorted(os.listdir(os.path.join(run, "stage1"))) == [
        "ckpt_0000002.pkl", "ckpt_0000003.pkl", "ckpt_0000004.pkl", "stage1_record.json"]
    with open(os.path.join(run, "report.json")) as fh:
        assert json.load(fh) == third
    for name in ("recovered_mesh.obj", "testviews.png", "ckpt_0000004.pkl",
                 "psnr_decomposition.json", "relight_eval.json", "relight_mosaic.png"):
        assert os.path.exists(os.path.join(run, name)), name
    dec, rel = reports["decomposition"], reports["relight"]
    assert set(dec) == {"scene", "rig", "res", "ckpt", "ckpt_step", "test_views", "configs",
                        "attribution_db", "device"}
    assert set(rel) == {"scene", "ckpt", "ckpt_step", "light_recovered", "novel_light",
                        "relight_psnr", "per_view", "device"}
    assert dec["ckpt_step"] == rel["ckpt_step"] == 4
    assert _finite(dec) and _finite(rel)
