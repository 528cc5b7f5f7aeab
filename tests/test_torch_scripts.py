"""The port's research scripts (iron_tpu_torch/scripts/) against the JAX
package's (scripts/singleview_demo.py, tracer_budget_coverage.py,
diag_torus_stage1.py, diag_torus_stage2.py, torus_resume_experiment.py,
silhouette_ab.py) on the CPU, at narrow widths.  Four of the JAX scripts
define their work inside main() or at module level, so each JAX expression
is rebuilt here from iron_tpu functions, citing the script's lines; a JAX
render is jitted with its weights as arguments.

  (1) one single-view step on a 32x32 crop holding silhouette pixels, with
      the crop and the eikonal points injected: the loss, its two terms and
      every SDF gradient leaf, at tests/test_torch_train.py's stage-2 step
      tolerances; the IoU of fixed masks;
  (2) a single-view run of 32 steps in blocks of 16 in a process where
      jax, the JAX package, optax, cv2, PIL and matplotlib cannot be
      imported: its mosaics, its checkpoint (read by the JAX package) and
      its last line;
  (3) the coverage shares at 16^2 and 24^2 against the JAX
      raytrace_pixels', to one pixel;
  (4) the torus stage-1 diagnostic's Euler characteristic and
      configurations against the JAX expressions, and a 4 + 2 step run;
  (5) the torus stage-2 diagnostic's fit loss, geometry report, hand-over
      and edge coverage against the JAX expressions;
  (6) the resume experiment from a checkpoint the JAX package wrote, its
      chamfer list against the JAX package's on the same files;
  (7) the silhouette A/B's configurations, and a 2 + 2 step run that
      writes report.json and resumes.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import build_jax_native_library, one_torch_thread  # noqa: F401
import jax
import jax.numpy as jnp

from iron_tpu.core.camera import Camera as JCamera
from iron_tpu.core.camera import crop_camera as j_crop_camera
from iron_tpu.core.camera import make_camera as j_make_camera
from iron_tpu.core.camera import pixel_grid as j_pixel_grid
from iron_tpu.core.camera import resize_camera as j_resize_camera
from iron_tpu.data import synthetic as jsyn
from iron_tpu.eval import independent_gt as jgt
from iron_tpu.eval.metrics import chamfer_distance as j_chamfer
from iron_tpu.export.mesh import extract_geometry as j_extract_geometry
from iron_tpu.export.mesh import largest_component as j_largest_component
from iron_tpu.fields import sdf as jsdf
from iron_tpu.surface.render import SurfaceRenderConfig as JSurf
from iron_tpu.surface.render import raytrace_pixels as j_raytrace_pixels
from iron_tpu.surface.render import render_camera as j_render
from iron_tpu.surface.render import scale_config_for_resolution as j_scale_cfg
from iron_tpu.surface.tracer import TracerConfig as JTracer
from iron_tpu.train.checkpoints import load_checkpoint as j_load_checkpoint
from iron_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from iron_tpu.train.stage1 import Stage1Config as JStage1Config
from iron_tpu.train.stage2 import Stage2Config as JStage2Config
from iron_tpu.train.stage2 import build_stage2_fns as j_build_stage2_fns
from iron_tpu.train.stage2 import init_stage2_params as j_init_stage2
from iron_tpu.volume.integrator import NeuSRenderConfig as JNeuSRender

from iron_tpu_torch.core.camera import make_camera
from iron_tpu_torch.data.synthetic import render_synthetic_dataset
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy
from iron_tpu_torch.scripts import (diag_torus_stage1, diag_torus_stage2, silhouette_ab,
                                    singleview_demo, torus_resume_experiment,
                                    tracer_budget_coverage)
from iron_tpu_torch.surface.render import SurfaceRenderConfig
from iron_tpu_torch.surface.tracer import TracerConfig
from iron_tpu_torch.train.checkpoints import params_from_numpy
from iron_tpu_torch.train.stage1 import STAGE1_COLOR
from iron_tpu_torch.train.stage2 import Stage2Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
T = lambda a: torch.as_tensor(np.asarray(a))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _sdf_grads(net):
    return {"layers": [{k: getattr(l, k).grad.numpy() for k in ("v", "g", "b")}
                       for l in net.layers]}


def _assert_same_fields(port, ref, dropped=(), path=""):
    """Every field of the JAX dataclass `ref` equal in the port's `port`
    (nested dataclasses field by field), but the `dropped` names, which the
    port leaves out."""
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


def _script_flags(name: str) -> dict:
    """{option: (default, type, choices, nargs, required)} of the
    add_argument calls in scripts/<name>.py."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", name + ".py")).read())
    flags = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            lit = lambda k, d=None: ast.literal_eval(kw[k]) if k in kw else d
            flags[node.args[0].value] = (lit("default"), kw["type"].id if "type" in kw else None,
                                         lit("choices"), lit("nargs"), lit("required", False))
    return flags


@pytest.mark.parametrize("module", [singleview_demo, tracer_budget_coverage,
                                    torus_resume_experiment, silhouette_ab],
                         ids=lambda m: m.__name__.split(".")[-1])
def test_flags_are_the_scripts(module):
    """Each module takes its JAX script's flags with their defaults, types,
    choices, nargs and required marks, and --device (default cuda)."""
    want = _script_flags(module.__name__.split(".")[-1])
    actions = {a.option_strings[-1]: a for a in module.arg_parser()._actions
               if a.option_strings and a.dest != "help"}
    assert set(actions) == set(want) | {"--device"}
    assert actions["--device"].default == "cuda"
    for flag, (default, typ, choices, nargs, required) in want.items():
        a = actions[flag]
        assert (a.default, a.type.__name__ if a.type else None,
                list(a.choices) if a.choices else None, a.nargs, a.required) == \
            (default, typ, choices, nargs, required), flag


@pytest.mark.parametrize("module,argv,want", [
    (diag_torus_stage1, [], (20000, 10000)), (diag_torus_stage1, ["300"], (300, 10000)),
    (diag_torus_stage1, ["300", "40"], (300, 40)),
    (diag_torus_stage2, [], (25000, 10, 256)), (diag_torus_stage2, ["40", "2", "64"], (40, 2, 64))],
    ids=lambda v: str(v) if isinstance(v, list) else None)
def test_positional_arguments_are_the_scripts(module, argv, want):
    """The two diagnostics read sys.argv[1:] positionally with the JAX
    scripts' defaults (scripts/diag_torus_stage1.py:12,47,
    diag_torus_stage2.py:29-31), and take --device."""
    args = module.arg_parser().parse_args(argv + ["--device", "cpu"])
    names = [a.dest for a in module.arg_parser()._actions
             if not a.option_strings and a.dest != "help"]
    assert tuple(getattr(args, n) for n in names) == want and args.device == "cpu"


# ---------------------------------------------------------------------------
# (1), (2) the single-view demo
# ---------------------------------------------------------------------------

PINK = jnp.asarray(singleview_demo.PINK)
CROP = dict(col=72, row=342)     # 32x32, 43 walked edge pixels at the narrow init


def _j_shade(ray_o, ray_d, pts, normals, feats):
    n = normals / (jnp.linalg.norm(normals, axis=-1, keepdims=True) + 1e-10)
    return {"color": jnp.broadcast_to(PINK, pts.shape[:-1] + (3,)), "normal": n}


def _j_singleview_loss(params, eik_pts, gt, K, W2C, H, W, ul_col, ul_row, ps, sdf_cfg):
    """scripts/singleview_demo.py:68-93 with the eikonal points given
    (:84 draws them from the step's key)."""
    scfg = JSurf(fill_holes=False, handle_edges=True, edge_budget=1024)
    sdf_fn = lambda p: jsdf.sdf_only(params, p, sdf_cfg)
    sdf_all_fn = lambda p: jsdf.sdf_value_feat_grad(params, p, sdf_cfg)
    K_j = jnp.asarray(K)
    cam = j_crop_camera(JCamera(K=K_j, W2C=jnp.asarray(W2C), K_inv=jnp.linalg.inv(K_j),
                                C2W=jnp.linalg.inv(jnp.asarray(W2C)), H=H, W=W),
                        ul_col, ul_row, ps, ps)
    gt_crop = jax.lax.dynamic_slice(gt, (ul_row, ul_col, 0), (ps, ps, 3))
    res = j_render(sdf_fn, sdf_all_fn, _j_shade, cam, scfg, is_training=True)
    mask = res["edge_mask"]
    m = mask[..., None].astype(jnp.float32)
    img_loss = jnp.sum(((res["color"] - gt_crop) ** 2) * m) / jnp.clip(jnp.sum(m), 1.0)
    g1 = jsdf.sdf_grad(params, eik_pts, sdf_cfg)
    all_mask = mask | res["convergent_mask"]
    e1 = (jnp.linalg.norm(g1, axis=-1) - 1) ** 2
    e2 = (jnp.linalg.norm(res["raw_grad"], axis=-1) - 1) ** 2 * all_mask
    e3 = ((jnp.linalg.norm(res["edge_pos_neg_normal"], axis=-1) - 1) ** 2
          * res["edge_pos_neg_mask"])
    cnt = e1.size + jnp.sum(all_mask) + jnp.sum(res["edge_pos_neg_mask"])
    eik = (jnp.sum(e1) + jnp.sum(e2) + jnp.sum(e3)) / jnp.clip(cnt, 1.0)
    return img_loss + 0.1 * eik, (img_loss, eik, jnp.sum(mask))


def test_singleview_step_matches_jax():
    """One single-view step at the narrow SDF (JAX init, transplanted) on a
    32x32 crop of the photo holding silhouette pixels, the 512 eikonal
    points drawn by numpy and given to both: the loss and its image and
    eikonal terms to rtol 2e-4, every SDF gradient leaf to rtol 2e-3 and
    atol 2e-3 of the leaf's largest entry (tests/test_torch_train.py's
    stage-2 step: the two tracers' roots agree to the 5e-5 threshold, not
    bit for bit)."""
    cfg = jsdf.SDFConfig(**NARROW)
    params = to_np(jsdf.init_sdf(jax.random.PRNGKey(0), cfg))
    gt, K, W2C, H, W = singleview_demo.load_view()
    ps = 32
    eik = np.random.default_rng(3).uniform(-1, 1, (ps * ps // 2, 3)).astype(np.float32)
    (jl, (ji, je, n_edge)), jg = jax.jit(jax.value_and_grad(
        lambda p, e, g: _j_singleview_loss(p, e, g, K, W2C, H, W, CROP["col"], CROP["row"],
                                           ps, cfg), has_aux=True))(params, eik, gt)
    assert int(n_edge) > 20

    net = sdf_from_numpy(params, SDFConfig(**NARROW), "cpu")
    base = make_camera(K, W2C, H, W, device="cpu")
    loss, (il, el) = singleview_demo.singleview_loss(net, T(gt), base, CROP["col"],
                                                     CROP["row"], T(eik), ps,
                                                     singleview_demo.surface_config())
    loss.backward()
    for got, ref in ((loss, jl), (il, ji), (el, je)):
        np.testing.assert_allclose(float(got), float(ref), rtol=2e-4, atol=1e-7)
    ref_g, got_g = _leaves(to_np(jg)), _leaves(_sdf_grads(net))
    assert set(ref_g) == set(got_g)
    for k, a in ref_g.items():
        np.testing.assert_allclose(got_g[k], a, rtol=2e-3,
                                   atol=2e-3 * float(np.abs(a).max()) + 1e-10, err_msg=k)


def test_silhouette_iou_is_the_scripts():
    """silhouette_iou against scripts/singleview_demo.py:145-150 on fixed
    masks: a disc of hits against a photo whose nonzero region is a square,
    and an empty render against an empty photo (union 0: IoU 0)."""
    g = np.random.default_rng(0)
    gt = np.zeros((512, 512, 3), np.float32)
    gt[100:400, 120:380] = g.uniform(0.02, 0.9, (300, 260, 3))
    gt[200:210, 200:210] = 0.01                  # summed channels 0.03: not the object
    yy, xx = np.mgrid[:128, :128]
    hit = (yy - 60) ** 2 + (xx - 62) ** 2 < 40 ** 2
    photo = gt[::4, ::4].sum(-1) > 0.05
    ref = float((hit & photo).sum() / max((hit | photo).sum(), 1))
    assert 0.3 < ref < 0.9
    assert singleview_demo.silhouette_iou(hit, gt) == ref
    assert singleview_demo.silhouette_iou(np.zeros_like(hit), np.zeros_like(gt)) == 0.0


_SINGLEVIEW_WITHOUT_JAX = r"""
import json, sys
for m in ("jax", "iron_tpu", "optax", "orbax", "cv2", "PIL", "matplotlib"):
    sys.modules[m] = None
import torch
torch.set_num_threads(1)
from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.scripts import singleview_demo as S
args = S.arg_parser().parse_args(["--iters", "32", "--patch", "32", "--log_every", "16",
                                  "--out_dir", sys.argv[1], "--device", "cpu"])
S.run(args, SDFConfig(d_out=33, d_hidden=32, n_layers=2, skip_in=(), multires=2), "cpu")
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "iron_tpu", "optax", "orbax", "cv2", "PIL", "matplotlib")]
assert not bad, bad
"""


def test_singleview_run_writes_the_scripts_outputs(tmp_path):
    """A single-view run with --iters 32 --patch 32 --log_every 16 (the SDF
    at d_hidden 32, 2 layers) in a process where jax, the JAX package,
    optax, orbax, cv2, PIL and matplotlib cannot be imported: two blocks of
    16 steps, each logged, so logim_000016.png and logim_000032.png (the
    mosaic of four 128x128 tiles), then ckpt_0000032.pkl, which the JAX
    package's load_checkpoint reads as an SDF tree of init_sdf's shapes,
    and a last line with the JAX script's keys (iters, iou, wall_s) and
    device."""
    from iron_tpu_torch.data.io import read_image
    out = subprocess.run([sys.executable, "-c", _SINGLEVIEW_WITHOUT_JAX, str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert [l.split()[0] for l in lines[:-1]] == ["[16]", "[32]"], lines
    last = json.loads(lines[-1])
    assert set(last) == {"iters", "iou", "wall_s", "device"}
    assert last["iters"] == 32 and last["device"] == "cpu" and 0 <= last["iou"] <= 1
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0000032.pkl", "logim_000016.png",
                                             "logim_000032.png"]
    assert read_image(str(tmp_path / "logim_000032.png")).shape == (128, 512, 3)
    ck = j_load_checkpoint(str(tmp_path / "ckpt_0000032.pkl"))
    ref = jsdf.init_sdf(jax.random.PRNGKey(0), jsdf.SDFConfig(d_out=33, d_hidden=32,
                                                              n_layers=2, skip_in=(), multires=2))
    assert ck["step"] == 32 and ck["opt_state"] is None
    assert jax.tree_util.tree_structure(ck["params"]) == jax.tree_util.tree_structure(to_np(ref))
    assert all(np.shape(a) == np.shape(b) for a, b in zip(jax.tree_util.tree_leaves(ck["params"]),
                                                          jax.tree_util.tree_leaves(ref)))


# ---------------------------------------------------------------------------
# (3) the tracer's coverage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [1024, 24])
def test_coverage_matches_jax_raytrace_pixels(budget):
    """The two shares at 16^2 and 24^2 for the narrow stage-2 SDF at the JAX
    init (the fallback budget as the script has it, 1024, and cut to 24 so
    that it binds) against scripts/tracer_budget_coverage.py:47-57 through
    the JAX package's raytrace_pixels (jitted with the weights as
    arguments): within one pixel.  The script's camera too."""
    surf = JSurf(tracer=JTracer(fallback_budget=budget))
    params = to_np(j_init_stage2(jax.random.PRNGKey(0),
                                 JStage2Config(sdf=jsdf.SDFConfig(**NARROW), surface=surf))[0])
    cfg = jsdf.SDFConfig(**NARROW)
    net = sdf_from_numpy(params["sdf"], SDFConfig(**NARROW), "cpu")
    tsurf = SurfaceRenderConfig(tracer=TracerConfig(fallback_budget=budget))
    for res in (16, 24):
        K, W2C = tracer_budget_coverage.coverage_camera(res)
        assert K[0, 0] == K[1, 1] == 1.25 * res and W2C[2, 3] == 3.0
        cam = j_make_camera(K, W2C, res, res)
        uv = j_pixel_grid(res, res)
        got = tracer_budget_coverage.coverage(net, tsurf, res, "cpu")
        for name, coarse in (("accurate_only", False), ("coarse_to_fine", True)):
            def conv(p):
                f = lambda x: jsdf.sdf_only(p, x, cfg)
                return j_raytrace_pixels(f, cam, uv, cfg=surf,
                                         coarse_sdf_fn=f if coarse else None)["convergent_mask"]
            ref = float(np.asarray(jax.jit(conv)(params["sdf"])).mean())
            assert ref > 0.05, (res, name)
            assert abs(got[name] - ref) * res * res <= 1, (res, name, got[name], ref)


def test_coverage_run_prints_the_scripts_lines(capsys):
    """run() prints one line a resolution with the JAX script's keys and
    device, the fallback budget the configuration's."""
    from iron_tpu_torch.train.stage2 import Stage2Config
    recs = tracer_budget_coverage.run([16, 20], "cpu", Stage2Config(sdf=SDFConfig(**NARROW)))
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert lines == recs and [r["res"] for r in recs] == [16, 20]
    for r in recs:
        assert set(r) == {"res", "fallback_budget", "accurate_only", "coarse_to_fine", "device"}
        assert r["fallback_budget"] == 1024 and r["device"] == "cpu"


# ---------------------------------------------------------------------------
# (4) the torus stage-1 diagnostic
# ---------------------------------------------------------------------------

def _j_euler(v, t):
    """scripts/diag_torus_stage1.py:36-42."""
    edges = set()
    for tri in t:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            edges.add((min(tri[a], tri[b]), max(tri[a], tri[b])))
    return len(v) - len(edges) + len(t)


@pytest.mark.parametrize("scene", ["sphere", "torus"])
def test_euler_characteristic_is_the_scripts(scene):
    """euler() of the largest component of the GT mesh at resolution 32,
    from the port's extract_geometry and from the JAX package's, against
    the script's expression on the JAX mesh: equal.  Neither is the
    genus's 2 (sphere) or 0 (torus): both packages' marching tetrahedra
    split neighbouring cells' shared faces along different diagonals
    (iron_tpu/native/mesh_native.cpp:30-33), so the mesh is cracked, many
    of its edges held by one triangle; the test holds that too, so that a
    repair of the reference shows here."""
    build_jax_native_library()
    jf = getattr(jsyn, f"{scene}_scene")()[0]
    from iron_tpu_torch.data import synthetic as tsyn
    from iron_tpu_torch.export.mesh import extract_geometry, largest_component
    tsdf = getattr(tsyn, f"{scene}_scene")()[0]
    jv, jt = j_largest_component(*j_extract_geometry(lambda p: -jf(p), resolution=32))
    tv, tt = largest_component(*extract_geometry(lambda p: -tsdf(p), resolution=32,
                                                 device="cpu"))
    ref = _j_euler(jv, jt)
    assert diag_torus_stage1.euler(jv, jt) == ref == diag_torus_stage1.euler(tv, tt)
    assert len(tv) == len(jv) and len(tt) == len(jt)
    e = np.sort(np.concatenate([jt[:, [0, 1]], jt[:, [1, 2]], jt[:, [2, 0]]]), axis=1)
    once = (np.unique(e, axis=0, return_counts=True)[1] == 1).sum()
    assert ref not in (0, 2) and once > 1000, (ref, once)


@pytest.mark.parametrize("iters,s2_iters", [(20000, 10000), (300, 40), (7, 4)])
def test_torus_stage1_configs_are_the_scripts(iters, s2_iters):
    """Both configurations field by field against the JAX package's built as
    scripts/diag_torus_stage1.py:17-20 and 49-54 build them (the JAX
    Stage1Config's upsample_precision and core_precision, which nothing in
    the port reads, left out)."""
    s1, s2 = diag_torus_stage1.configs(iters, s2_iters)
    _assert_same_fields(s1, JStage1Config(
        end_iter=iters, warm_up_end=iters // 20, anneal_end=iters // 2, batch_size=512,
        sdf=jsdf.SDFConfig(bias=0.5), mask_weight=0.1,
        render=JNeuSRender(n_samples=64, n_importance=64, n_outside=0, up_sample_steps=4,
                           perturb=1.0)), dropped=("upsample_precision", "core_precision"))
    _assert_same_fields(s2, JStage2Config(renderer_name="ggx", patch_size=128,
                                          num_iters=s2_iters, surface=JSurf(edge_budget=1024),
                                          save_freq=10 ** 9))


def _narrow_stage1(cfg):
    return dataclasses.replace(
        cfg, batch_size=64, sdf=SDFConfig(bias=0.5, **NARROW),
        color=dataclasses.replace(STAGE1_COLOR, d_feature=32, d_hidden=32, n_layers=4,
                                  skip_in=(2,)),
        render=dataclasses.replace(cfg.render, n_samples=8, n_importance=8))


def _narrow_stage2(cfg, **kw):
    return dataclasses.replace(cfg, patch_size=32, sdf=SDFConfig(**NARROW), **kw)


def test_torus_stage1_run_prints_the_scripts_lines(capsys):
    """A run of 4 stage-1 and 2 stage-2 steps (narrow networks, 8 + 8
    samples, 32x32 views, crops of 32, the meshes at 32) prints the
    script's four lines: "final:", the stage-1 JSON with its keys and
    device, "stage2 final:", the stage-2 JSON with its keys and device; the
    GT torus's SDF at the hole is R - r = 0.24."""
    s1, s2 = diag_torus_stage1.configs(4, 2)
    out = diag_torus_stage1.run(4, 2, "cpu", _narrow_stage1(s1), _narrow_stage2(s2), res=32,
                                mesh_resolution=32)
    lines = [l for l in capsys.readouterr().out.splitlines() if not l.startswith("[stage")]
    assert [l.split()[0] for l in lines] == ["final:", "{\"verts\":", "stage2", "{\"post_stage2_chamfer\":"]
    rec1, rec2 = json.loads(lines[1]), json.loads(lines[3])
    assert set(rec1) == {"verts", "verts_largest", "euler_largest", "euler_gt", "chamfer",
                         "sdf_at_hole", "gt_sdf_at_hole", "device"}
    assert set(rec2) == {"post_stage2_chamfer", "post_stage2_sdf_at_hole", "post_stage2_verts",
                         "device"}
    assert rec1 == out["stage1"] and rec2 == out["stage2"] and rec1["device"] == "cpu"
    assert rec1["gt_sdf_at_hole"] == pytest.approx(0.24, abs=1e-6)
    assert all(np.isfinite(v) for r in (rec1, rec2) for v in r.values() if v != "cpu")


# ---------------------------------------------------------------------------
# (5) the torus stage-2 diagnostic
# ---------------------------------------------------------------------------

def test_fit_loss_matches_jax():
    """fit_loss on 8,192 injected points (the cube's and perturbed GT
    vertices, as fit_points draws them) against
    scripts/diag_torus_stage2.py:43-51's expression, to 1e-5 relative, with
    its gradient to the same; fit_points' shape and spread."""
    cfg = jsdf.SDFConfig(bias=0.5, **NARROW)
    params = to_np(jsdf.init_sdf(jax.random.PRNGKey(0), cfg))
    gt_sdf = jsyn.torus_scene()[0]
    g = np.random.default_rng(1)
    verts = g.normal(size=(500, 3)).astype(np.float32) * 0.4
    gen = torch.Generator().manual_seed(1)
    x = diag_torus_stage2.fit_points(gen, T(verts))
    assert x.shape == (8192, 3) and float(x[:4096].abs().max()) <= 1
    d = (x[4096:, None, :] - T(verts)[None]).norm(dim=-1).min(dim=1).values
    assert 0.02 < float(d.mean()) < 0.05
    ref_l, ref_g = jax.value_and_grad(
        lambda p: jnp.mean((jsdf.sdf_only(p, jnp.asarray(x.numpy()), cfg)
                            - gt_sdf(jnp.asarray(x.numpy()))) ** 2))(params)
    from iron_tpu_torch.data.synthetic import torus_scene
    net = sdf_from_numpy(params, SDFConfig(bias=0.5, **NARROW), "cpu")
    loss = diag_torus_stage2.fit_loss(net, torus_scene()[0], x)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(ref_l), rtol=1e-5)
    for k, a in _leaves(to_np(ref_g)).items():
        np.testing.assert_allclose(_leaves(_sdf_grads(net))[k], a, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(a).max()), err_msg=k)


def test_geometry_report_matches_jax(capsys):
    """geometry_report at resolution 32 against
    scripts/diag_torus_stage2.py:68-82 through the JAX package's
    extract_geometry, largest_component and chamfer_distance (the GT torus
    meshed at 32): the same vertex counts and rounded SDF probe, the
    chamfer to 1e-6 relative; printed as one JSON line with device."""
    build_jax_native_library()
    cfg = jsdf.SDFConfig(bias=0.45, **NARROW)
    params = to_np(jsdf.init_sdf(jax.random.PRNGKey(2), cfg))
    gt_sdf = jsyn.torus_scene()[0]
    gv, gt = j_largest_component(*j_extract_geometry(lambda p: -gt_sdf(p), resolution=32))
    rep = diag_torus_stage2.geometry_report(sdf_from_numpy(params, SDFConfig(bias=0.45, **NARROW),
                                                           "cpu"), gv, gt, "fitted_init", "cpu",
                                            "cpu", resolution=32)
    assert json.loads(capsys.readouterr().out) == rep
    v, t = j_extract_geometry(lambda p: -jsdf.sdf_only(params, p, cfg), resolution=32)
    vl, tl = j_largest_component(v, t)
    probe = jnp.stack([jnp.zeros(5), jnp.linspace(-0.1, 0.1, 5), jnp.zeros(5)], -1)
    assert rep["tag"] == "fitted_init" and rep["device"] == "cpu"
    assert (rep["verts"], rep["verts_largest"]) == (len(v), len(vl))
    assert rep["sdf_at_hole"] == [round(float(s), 4) for s in jsdf.sdf_only(params, probe, cfg)]
    np.testing.assert_allclose(rep["chamfer"], j_chamfer(vl, tl, gv, gt), rtol=1e-6)


def test_hand_over_trains_the_fitted_sdf():
    """hand_over copies the fitted weights into the trainer's SDF module and
    rebuilds its optimizer on the trainer's parameters: the trainer then
    evaluates the fitted SDF, and one step moves every SDF leaf (an
    optimizer still holding the replaced parameters would move none)."""
    from iron_tpu_torch.fields.sdf import init_sdf, sdf_only
    data = render_synthetic_dataset("torus", n_views=2, H=32, W=32, light=30.0, device="cpu")
    cfg = _narrow_stage2(diag_torus_stage2.stage2_config(1, 32))
    tr = Stage2Trainer(cfg, data["images"], data["Ks"], data["W2Cs"], device="cpu")
    net = init_sdf(SDFConfig(**NARROW, bias=0.3), torch.Generator().manual_seed(5), "cpu")
    diag_torus_stage2.hand_over(tr, net)
    x = torch.rand(64, 3) * 2 - 1
    with torch.no_grad():
        assert torch.equal(sdf_only(tr.params["sdf"], x), sdf_only(net, x))
    held = {id(p) for g in tr.opt.opt.param_groups for p in g["params"]}
    assert {id(p) for p in tr.params["sdf"].parameters()} <= held
    before = [p.detach().clone() for p in tr.params["sdf"].parameters()]
    tr.run(num_iters=1)
    moved = [not torch.equal(a, p.detach()) for a, p in zip(before, tr.params["sdf"].parameters())]
    assert all(moved), moved


def test_edge_coverage_matches_jax(capsys):
    """edge_coverage of view 0 of the torus (32x32 data) at 32^2 and 64^2
    for transplanted ggx parameters against scripts/diag_torus_stage2.py:
    117-132 through the JAX package's build_stage2_fns and render_camera
    (the sdf / sdf_all / shade evaluators alone, jitted with the weights as
    arguments): the scaled budget equal, the seed, drop and edge-pixel
    counts within 2 pixels."""
    jcfg = JStage2Config(renderer_name="ggx", patch_size=32, sdf=jsdf.SDFConfig(**NARROW),
                         surface=JSurf(edge_budget=1024))
    params, mats = j_init_stage2(jax.random.PRNGKey(4), jcfg)
    params = to_np(params)
    data = render_synthetic_dataset("torus", n_views=1, H=32, W=32, light=30.0, device="cpu")
    cfg = _narrow_stage2(diag_torus_stage2.stage2_config(1, 32))
    tr = Stage2Trainer(cfg, data["images"], data["Ks"], data["W2Cs"], device="cpu")
    tr.params = params_from_numpy(params, "cpu", cfg.sdf, "ggx")
    for side in (32, 64):
        got = diag_torus_stage2.edge_coverage(tr, data, 32, side, "cpu")
        assert json.loads(capsys.readouterr().out) == got
        cam = j_resize_camera(j_make_camera(data["Ks"][0], data["W2Cs"][0], 32, 32), side / 32)
        surf = j_scale_cfg(jcfg.surface, cam.H, cam.W, train_patch=jcfg.patch_size)

        def render(p):
            f = j_build_stage2_fns(p, mats, jcfg)
            res = j_render(f["sdf_fn"], f["sdf_all_fn"], f["shade_fn"], cam, surf)
            return res["edge_seed_count"], res["edge_seeds_dropped"], jnp.sum(res["edge_mask"])

        seeds, dropped, pixels = (int(v) for v in jax.jit(render)(params))
        assert got["edge_budget"] == surf.edge_budget and pixels > 5
        for k, ref in (("edge_seed_count", seeds), ("edge_seeds_dropped", dropped),
                       ("edge_pixels", pixels)):
            assert abs(got[k] - ref) <= 2, (side, k, got[k], ref)


# ---------------------------------------------------------------------------
# (6) the resume experiment
# ---------------------------------------------------------------------------

def test_resume_from_a_jax_checkpoint_scores_as_jax(tmp_path, capsys):
    """torus_resume_experiment on a stage-2 checkpoint written by the JAX
    package's save_checkpoint (narrow ggx parameters at step 12,000): the
    clip arm (Stage2Config.grad_clip = --clip) resumes at step 35,000 and
    two steps write ckpt_0035001.pkl and ckpt_0035002.pkl (a checkpoint a
    step; the independent renderer's torus at 48x48, crops of 32, its GT
    mesh at 48); their chamfer list against the same steps through the JAX
    package (extract_geometry at 32, largest_component, chamfer_distance
    against mesh_scene_np of the torus at 48) on the same files: the same
    names and vertex counts, chamfers to 1e-6 relative, and the lines the
    script prints."""
    build_jax_native_library()
    jcfg = JStage2Config(renderer_name="ggx", sdf=jsdf.SDFConfig(**NARROW))
    params = to_np(j_init_stage2(jax.random.PRNGKey(6), jcfg)[0])
    ck = j_save_checkpoint(str(tmp_path / "src"), 12000, params)
    out_dir = str(tmp_path / "run")
    args = torus_resume_experiment.arg_parser().parse_args(
        ["--arm", "clip", "--clip", "0.5", "--iters", "2", "--from_ckpt", ck, "--out_dir", out_dir,
         "--device", "cpu"])
    cfg = torus_resume_experiment.stage2_config(args.arm, args.clip)
    assert cfg.grad_clip == 0.5 and torus_resume_experiment.stage2_config("control", 0.5).grad_clip == 0
    _assert_same_fields(cfg, JStage2Config(renderer_name="ggx", patch_size=128, num_iters=100000,
                                           surface=JSurf(edge_budget=1024), save_freq=5000,
                                           grad_clip=0.5))
    data = torus_resume_experiment.make_data(res=48, mesh_resolution=48)
    got = torus_resume_experiment.run(args, _narrow_stage2(cfg, save_freq=1), "cpu", data=data,
                                      mesh_resolution=32, gt_mesh_resolution=48)
    assert [r["ckpt"] for r in got] == ["ckpt_0035001.pkl", "ckpt_0035002.pkl"]
    gv, gt = jgt.mesh_scene_np(jgt.SCENES_NP["torus"](), resolution=48)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[clip] ckpt")]
    for rec, line in zip(got, lines):
        c = j_load_checkpoint(os.path.join(out_dir, rec["ckpt"]))
        assert c["step"] == int(rec["ckpt"][5:12])
        v, t = j_largest_component(*j_extract_geometry(
            lambda q: -jsdf.sdf_only(c["params"]["sdf"], q, jsdf.SDFConfig(**NARROW)),
            resolution=32))
        ch = j_chamfer(v, t, gv, gt)
        assert rec["verts"] == len(v)
        np.testing.assert_allclose(rec["chamfer"], ch, rtol=1e-6)
        assert line == f"[clip] {rec['ckpt']}: verts={len(v)} chamfer={rec['chamfer']:.4f}"


# ---------------------------------------------------------------------------
# (7) the silhouette A/B
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--res", "64", "--silhouette_weight", "0.5",
                                       "--stage1_iters", "200", "--stage2_iters", "40",
                                       "--ckpt_every", "20"]])
def test_silhouette_ab_configs_are_the_scripts(argv):
    """Each arm's Stage2Config field by field against the JAX package's
    built as scripts/silhouette_ab.py:317-323 builds it; the stage-1
    configuration against the JAX Stage1Config with the script's fields and
    end_iter = --stage1_iters (the script's num_iters=, which the JAX
    Stage1Config refuses)."""
    args = silhouette_ab.arg_parser().parse_args(argv)
    for arm in ("control", "silhouette"):
        _assert_same_fields(silhouette_ab.stage2_config(args, arm), JStage2Config(
            renderer_name="ggx", patch_size=min(args.res, 128), num_iters=args.stage2_iters,
            silhouette_weight=args.silhouette_weight if arm == "silhouette" else 0.0,
            surface=JSurf(edge_budget=1024), save_freq=args.ckpt_every))
    kw = dict(batch_size=512, sdf=jsdf.SDFConfig(bias=0.5), mask_weight=0.1,
              render=JNeuSRender(n_samples=64, n_importance=64, n_outside=0, up_sample_steps=4,
                                 perturb=1.0))
    with pytest.raises(TypeError, match="num_iters"):
        JStage1Config(num_iters=args.stage1_iters, **kw)
    _assert_same_fields(silhouette_ab.stage1_config(args),
                        JStage1Config(end_iter=args.stage1_iters, **kw),
                        dropped=("upsample_precision", "core_precision"))


def test_silhouette_ab_runs_and_resumes(tmp_path, capsys):
    """A 2 + 2 step A/B at 32x32 with --ckpt_every 1 (narrow networks, 8 +
    8 samples, crops of 32, stage 1 saving every step, the meshes at 32):
    report.json with the JAX script's keys (scripts/silhouette_ab.py:
    312-315, 339-349) and device, a trajectory row at steps 1 and 2 of each
    arm, every number finite; a second call resumes both stages at step 2,
    trains nothing, keeps the trajectories empty and counts no rays."""
    argv = ["--out_dir", str(tmp_path), "--res", "32", "--stage1_iters", "2",
            "--stage2_iters", "2", "--ckpt_every", "1", "--device", "cpu"]
    args = silhouette_ab.arg_parser().parse_args(argv)
    s1 = dataclasses.replace(_narrow_stage1(silhouette_ab.stage1_config(args)), save_freq=1)
    s2_of = lambda arm: _narrow_stage2(silhouette_ab.stage2_config(args, arm))
    rep = silhouette_ab.run(args, s1, s2_of, "cpu", mesh_resolution=32)
    with open(tmp_path / "report.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(rep, default=float))
    assert set(rep) == {"scene", "rig", "res", "stage1_iters", "stage2_iters",
                        "silhouette_weight", "arms", "device"}
    assert list(rep["arms"]) == ["control", "silhouette"] and rep["device"] == "cpu"
    for arm in rep["arms"].values():
        assert set(arm) == {"trajectory", "rays_per_s"} and arm["rays_per_s"] > 0
        assert list(arm["trajectory"]) == [1, 2]
        for row in arm["trajectory"].values():
            assert set(row) == {"verts", "chamfer", "mask_miss", "mask_excess"}
            assert all(np.isfinite(v) for v in row.values())
    first = capsys.readouterr().out
    assert "[stage1] resumed" not in first and "[control 2] chamfer" in first

    again = silhouette_ab.run(args, s1, s2_of, "cpu", mesh_resolution=32)
    second = capsys.readouterr().out
    for line in ("[stage1] resumed at 2", "[control] resumed at 2", "[silhouette] resumed at 2"):
        assert line in second
    assert "[stage1 " not in second and "[control 1]" not in second
    assert again["arms"] == {arm: {"trajectory": {}, "rays_per_s": 0.0}
                             for arm in ("control", "silhouette")}
