"""The port's export and eval modules against the JAX package on the CPU:
the native mesh runtime (the same C++ source, built by each package), the
SDF grid sweep, marching cubes and the two-pass export on a transplanted
SDF, the UV unwrap, the baked material atlases on transplanted material
networks, the image and mesh metrics, the relighting renders, and the
port's `train_volume --mode validate_mesh` on a JAX-written checkpoint.

Every test that reaches the JAX package's native library lives in this
file: the JAX loader builds its library beside its source, and one file
runs in one pytest worker."""
import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import jax.numpy as jnp

from iron_tpu import native as jnative
from iron_tpu.config import load_config_file as j_load_config
from iron_tpu.config import stage1_config_from_dict as j_stage1_config
from iron_tpu.core.camera import make_camera as j_make_camera
from iron_tpu.eval import metrics as jmetrics
from iron_tpu.eval import relight as jrelight
from iron_tpu.export import materials as jmaterials
from iron_tpu.export import mesh as jmesh
from iron_tpu.export import uv as juv
from iron_tpu.fields import sdf as jsdf
from iron_tpu.shading.materials import get_materials_comp as j_get_materials_comp
from iron_tpu.shading.materials import renderer_network_configs as j_net_cfgs
from iron_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from iron_tpu.train.stage1 import init_stage1_params as j_init_stage1

from iron_tpu_torch import native as tnative
from iron_tpu_torch.cli import train_surface as cli_surface
from iron_tpu_torch.cli import train_volume as cli_volume
from iron_tpu_torch.core.camera import make_camera
from iron_tpu_torch.eval import metrics as tmetrics
from iron_tpu_torch.eval import relight as trelight
from iron_tpu_torch.export import materials as tmaterials
from iron_tpu_torch.export import mesh as tmesh
from iron_tpu_torch.export import uv as tuv
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_only
from iron_tpu_torch.train.checkpoints import params_to_numpy
from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def sdf_pair():
    """A narrow SDF from the JAX package's geometric init (a sphere of
    radius ~0.5) and its port transplant: (jax fn, port fn)."""
    jcfg = jsdf.SDFConfig(**NARROW)
    params = to_np(jsdf.init_sdf(jax.random.PRNGKey(3), jcfg))
    net = sdf_from_numpy(params, SDFConfig(**NARROW), "cpu")
    return (lambda p: jsdf.sdf_only(params, p, jcfg)), (lambda p: sdf_only(net, p))


@pytest.fixture(scope="module")
def sphere_mesh():
    """A marching-cubes sphere (the JAX package's native library)."""
    verts, tris = jmesh.extract_geometry(lambda p: -(jnp.linalg.norm(p, axis=-1) - 0.5),
                                         resolution=24)
    return jmesh.largest_component(verts, tris)


def test_native_source_is_a_copy():
    assert filecmp.cmp(os.path.join(REPO, "iron_tpu", "native", "mesh_native.cpp"),
                       os.path.join(REPO, "iron_tpu_torch", "native", "mesh_native.cpp"),
                       shallow=False)


def test_native_library_matches_jax(sphere_mesh):
    """marching_cubes, point_mesh_sq_distances and ray_mesh_intersect of
    both packages' builds on the same arrays, bit for bit."""
    g = np.random.default_rng(0)
    field = g.normal(size=(12, 10, 14)).astype(np.float32)
    origin, spacing = np.array([-1.0, -0.5, -1.2], np.float32), np.array([0.2, 0.1, 0.15],
                                                                           np.float32)
    for iso in (0.0, 0.3):
        a, b = jnative.marching_cubes(field, origin, spacing, iso), \
            tnative.marching_cubes(field, origin, spacing, iso)
        assert len(a[1]) > 0
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    verts, tris = sphere_mesh
    pts = g.uniform(-1, 1, size=(500, 3)).astype(np.float32)
    np.testing.assert_array_equal(jnative.point_mesh_sq_distances(pts, verts, tris),
                                  tnative.point_mesh_sq_distances(pts, verts, tris))
    ro = np.tile(np.array([[0.0, 0.0, 3.0]], np.float32), (400, 1))
    rd = np.concatenate([g.normal(size=(400, 2)) * 0.2, -np.ones((400, 1))], 1)
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    a, b = jnative.ray_mesh_intersect(ro, rd, verts, tris), \
        tnative.ray_mesh_intersect(ro, rd, verts, tris)
    assert (a[0] > 0).sum() > 50 and (a[0] < 0).sum() > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="out of range"):
        tnative.point_mesh_sq_distances(pts, verts[:3], tris)


def test_sdf_grid_extract_geometry_and_export_mesh_match_jax(sdf_pair, tmp_path):
    """The grid sweep within 1e-5 of the JAX package's `_eval_sdf_grid`;
    extract_geometry and the two-pass export_mesh with the same vertex and
    face counts and vertices within 1e-4 (export_mesh: of the other mesh's
    surface, see below)."""
    jfn, tfn = sdf_pair
    g = np.random.default_rng(1)
    pts = g.uniform(-1, 1, size=(3000, 3)).astype(np.float32)
    ref = jmesh._eval_sdf_grid(jfn, pts, chunk=1024)
    got = tmesh._eval_sdf_grid(tfn, pts, chunk=1024, device="cpu")
    assert got.shape == ref.shape == (3000,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

    a = jmesh.extract_geometry(lambda p: -jfn(p), resolution=40)
    b = tmesh.extract_geometry(lambda p: -tfn(p), resolution=40, device="cpu")
    assert a[0].shape == b[0].shape and a[1].shape == b[1].shape and len(a[1]) > 1000
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_allclose(b[0], a[0], rtol=0, atol=1e-4)

    # The second pass samples a grid in the PCA frame of the first pass's
    # mesh, whose vertices differ by the SDF's f32 sums, so its grid points
    # and values differ slightly.  A marching vertex on a grid edge nearly
    # tangent to the surface moves along that edge by spacing * df / |f0 -
    # f1|, far more than df for a few such edges, but stays on the surface:
    # held are every vertex within 1e-4 of the other package's mesh (both
    # ways), and 99.5% of them within 1e-4 coordinate-wise.
    va, ta = jmesh.export_mesh(jfn, str(tmp_path / "a.obj"), resolution=48, low_res=32)
    vb, tb = tmesh.export_mesh(tfn, str(tmp_path / "b.obj"), resolution=48, low_res=32,
                               device="cpu")
    assert va.shape == vb.shape and ta.shape == tb.shape
    np.testing.assert_array_equal(ta, tb)
    assert np.sqrt(tnative.point_mesh_sq_distances(vb, va, ta)).max() <= 1e-4
    assert np.sqrt(tnative.point_mesh_sq_distances(va, vb, tb)).max() <= 1e-4
    assert (np.abs(vb - va).max(axis=1) <= 1e-4).mean() >= 0.995
    rb = tmesh.read_obj(str(tmp_path / "b.obj"))
    assert rb[0].shape == vb.shape and rb[1].shape == tb.shape
    # orient_faces with the SDF (the port's runs it on the device given)
    np.testing.assert_array_equal(
        jmesh.orient_faces(va, ta, sdf_fn=jfn),
        tmesh.orient_faces(vb, tb, sdf_fn=tfn, device="cpu"))


@pytest.mark.parametrize("text", [
    "v 1 2 3\nv 4 5 6 7\nv 1 1 1\nf 1 2 3\n",
    "v 1 2 3\nvn 0 0 1\nv 2 3 4\nv 5 6 7\nf 1//1 2//1 3//1\n",
    "  v 1 2 3\nv 1 2 3\nv 3 4 5\nf 1 2 3\n",
    "v 1 2 3\r\nv 2 3 4\r\nv 4 5 6\r\nf 1 2 3\r\n",
    "v 1 2 3\nv 2 3 4\nv 4 5 6\nv 1 1 1\nv 2 2 2\nv 3 3 3\nf 1 2 3 4 5 6\n",
    "v 1 2 3\nv 2 3 4\nv 4 5 6\nvt 0 0\nf 1/1/1 2/1/1 3/1/1\n",
    "v 1 2 3 # c\nv 2 3 4\nv 4 5 6\nf 1 2 3\n",
    "# c\nmtllib m.mtl\nv 1 2 3\nv 2 3 4\nv 4 5 6\nvn 0 0 1\nvt 0.5 0.5\nf 1/1 2/1 3/1\n"])
def test_obj_io_matches_jax(tmp_path, text):
    """The port's column-wise OBJ writer writes the JAX package's bytes, and
    its reader (the byte scan, or the JAX package's line parser for other
    layouts) returns the JAX package's arrays."""
    g = np.random.default_rng(8)
    V = (g.normal(size=(40, 3)) * 10.0).astype(np.float32)
    V[0] = [-0.0, 1e-9, 123456.789]
    T = g.integers(0, 40, size=(60, 3)).astype(np.int32)
    UV = g.uniform(size=(180, 2)).astype(np.float32)
    TU = np.arange(180, dtype=np.int32).reshape(60, 3)
    files = [str(tmp_path / "odd.obj")]
    with open(files[0], "w", newline="") as f:
        f.write(text)
    for i, args in enumerate([(V, T), (V, T, UV, TU), (V, T, UV, TU, "mesh"),
                              (V.astype(np.float64), T.astype(np.int64))]):
        jmesh.write_obj(str(tmp_path / f"j{i}.obj"), *args)
        tmesh.write_obj(str(tmp_path / f"t{i}.obj"), *args)
        assert filecmp.cmp(str(tmp_path / f"j{i}.obj"), str(tmp_path / f"t{i}.obj"),
                           shallow=False)
        files.append(str(tmp_path / f"j{i}.obj"))
    for path in files:
        for x, y in zip(jmesh.read_obj(path), tmesh.read_obj(path)):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), path


def test_uv_unwrap_matches_jax(sphere_mesh, tmp_path):
    """The UV module is a host-numpy copy: every output bit for bit."""
    verts, tris = sphere_mesh
    for fn in ("smart_uv_unwrap", "grid_uv_unwrap"):
        for x, y in zip(getattr(juv, fn)(verts, tris), getattr(tuv, fn)(verts, tris)):
            np.testing.assert_array_equal(x, y)
    jmesh.write_obj(str(tmp_path / "m.obj"), verts, tris)
    juv.unwrap_obj(str(tmp_path / "m.obj"), str(tmp_path / "j.obj"))
    tuv.unwrap_obj(str(tmp_path / "m.obj"), str(tmp_path / "t.obj"))
    assert filecmp.cmp(str(tmp_path / "j.obj"), str(tmp_path / "t.obj"), shallow=False)


@pytest.fixture(scope="module")
def stage2_trainer():
    """A port Stage2Trainer (comp, narrow SDF) on the CPU, and its
    parameters as the JAX tree."""
    g = np.random.default_rng(2)
    images = g.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    from iron_tpu_torch.data.synthetic import ring_cameras
    Ks, W2Cs = ring_cameras(2, H=16, W=16)
    tt = Stage2Trainer(Stage2Config(sdf=SDFConfig(**NARROW)), images, Ks, W2Cs,
                       generator=torch.Generator().manual_seed(4), device="cpu")
    return tt, params_to_numpy(tt.params)


def test_material_atlases_match_jax(stage2_trainer, sdf_pair, tmp_path_factory):
    """export_materials in both packages on the same UV-unwrapped mesh, the
    port through the CLI's material_predictor (the shading path's sdf_all:
    on the CPU the f32 core with autograd) and the JAX package through its
    export_assets predictor on the transplanted parameters: every atlas
    within 1/255, the coverage identical."""
    tt, tree = stage2_trainer
    tmp = tmp_path_factory.mktemp("atlas")
    mesh_path = str(tmp / "mesh.obj")
    tmesh.export_mesh(lambda p: sdf_only(tt.params["sdf"], p), mesh_path, resolution=40,
                      low_res=32, device="cpu")
    tuv.unwrap_obj(mesh_path, mesh_path)
    jcfg = jsdf.SDFConfig(**NARROW)
    mat_cfgs = j_net_cfgs("comp", d_feature=NARROW["d_out"] - 1)

    def j_predictor(points):
        _, feats, normals = jsdf.sdf_value_feat_grad(tree["sdf"], points, jcfg)
        normals = normals / (jnp.linalg.norm(normals, axis=-1, keepdims=True) + 1e-10)
        res = j_get_materials_comp(tree["materials"], mat_cfgs, points, normals, feats)
        return res["diffuse_albedo"], res["specular_albedo"], res["specular_roughness"]

    kw = dict(n_rounds=2, samples_per_round=6_000, chunk=4_096, texture_H=96, texture_W=96)
    ref = jmaterials.export_materials(mesh_path, j_predictor, str(tmp / "jax"), **kw)
    got = tmaterials.export_materials(mesh_path, cli_surface.material_predictor(tt),
                                      str(tmp / "port"), device="cpu", **kw)
    np.testing.assert_array_equal(ref["coverage"], got["coverage"])
    assert ref["coverage"].mean() > 0.05
    for k in ("diffuse_albedo", "specular_albedo", "roughness"):
        assert np.abs(got[k] - ref[k]).max() <= 1 / 255, k
        assert filecmp.cmp(str(tmp / "jax" / "mesh.mtl"), str(tmp / "port" / "mesh.mtl"))
    # the samples themselves: the same RNG stream in both packages
    v, t, uvs, tuvs = tmesh.read_obj(mesh_path)
    for x, y in zip(jmaterials.sample_surface(v, t, uvs, tuvs, 100),
                    tmaterials.sample_surface(v, t, uvs, tuvs, 100)):
        np.testing.assert_array_equal(x, y)


def _smooth_image(g, H, W):
    x = g.uniform(size=(H, W, 3)).astype(np.float32)
    for _ in range(3):
        x = 0.25 * (np.roll(x, 1, 0) + np.roll(x, -1, 0) + np.roll(x, 1, 1) + np.roll(x, -1, 1))
    return x


def test_image_and_mesh_metrics_match_jax(sphere_mesh, tmp_path):
    """psnr_np, ssim_np and perceptual_distance_np within 1e-5 relative of
    the JAX package's; chamfer_distance and eval_image_folder on PNGs the
    same; lpips_np None without local weights in both."""
    from iron_tpu_torch.data.io import write_image
    g = np.random.default_rng(5)
    gt = _smooth_image(g, 48, 40)
    pred = np.clip(gt + 0.05 * g.normal(size=gt.shape).astype(np.float32), 0, 1)
    assert tmetrics.psnr_np(pred, gt) == jmetrics.psnr_np(pred, gt)
    for name in ("ssim_np", "perceptual_distance_np"):
        a = getattr(jmetrics, name)(pred, gt)
        b = getattr(tmetrics, name)(pred, gt, device="cpu")
        assert abs(b - a) <= 1e-5 * abs(a), (name, a, b)
    assert tmetrics.lpips_np(pred, gt, device="cpu") is None
    v1, t1 = sphere_mesh
    v2 = (v1 * 0.9).astype(np.float32)
    assert tmetrics.chamfer_distance(v1, t1, v2, t1) == jmetrics.chamfer_distance(v1, t1, v2, t1)
    os.makedirs(tmp_path / "pred")
    os.makedirs(tmp_path / "gt")
    for i in range(2):
        write_image(str(tmp_path / "pred" / f"{i}.png"), np.roll(pred, i, 0))
        write_image(str(tmp_path / "gt" / f"{i}.png"), gt)
    a = jmetrics.eval_image_folder(str(tmp_path / "pred"), str(tmp_path / "gt"),
                                   str(tmp_path / "j.txt"))
    b = tmetrics.eval_image_folder(str(tmp_path / "pred"), str(tmp_path / "gt"),
                                   str(tmp_path / "t.txt"), device="cpu")
    assert a.keys() == b.keys() and a["n_images"] == b["n_images"] == 2
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-5 * abs(a[k]), k
    assert open(tmp_path / "j.txt").read() == open(tmp_path / "t.txt").read()


@pytest.fixture(scope="module")
def exported_assets(tmp_path_factory):
    """An exported sphere with baked, position-dependent atlases."""
    tmp = tmp_path_factory.mktemp("assets")
    mesh_path = str(tmp / "mesh.obj")
    tmesh.export_mesh(lambda p: torch.linalg.norm(p, dim=-1) - 0.5, mesh_path, resolution=40,
                      low_res=32, device="cpu")
    tuv.unwrap_obj(mesh_path, mesh_path)

    def predictor(p):
        return (torch.clamp(torch.abs(p) + 0.2, 0, 1), torch.full_like(p, 0.25),
                0.2 + 0.3 * torch.abs(p[:, :1]))

    tmaterials.export_materials(mesh_path, predictor, str(tmp), n_rounds=1,
                                samples_per_round=60_000, texture_H=128, texture_W=128,
                                device="cpu")
    return str(tmp), mesh_path


def test_relight_renders_match_jax(exported_assets):
    """render_mesh_flash (co-located and a novel light) and
    render_mesh_envmap at 32x32 within 1e-5 of the JAX package's."""
    out_dir, mesh_path = exported_assets
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 40.0
    K[0, 2] = K[1, 2] = 16.0
    W2C = np.eye(4, dtype=np.float32)
    W2C[:3, :3] = np.diag([1.0, -1.0, -1.0])
    W2C[2, 3] = 3.0
    jcam, tcam = j_make_camera(K, W2C, 32, 32), make_camera(K, W2C, 32, 32, device="cpu")
    for lp in (None, np.array([2.0, 1.0, 1.0])):
        a = jrelight.render_mesh_flash(mesh_path, out_dir, jcam, light=30.0, light_pos=lp)
        b = trelight.render_mesh_flash(mesh_path, out_dir, tcam, light=30.0, light_pos=lp)
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert a["mask"].mean() > 0.1
        np.testing.assert_allclose(b["color"], a["color"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b["depth"], a["depth"], rtol=1e-6, atol=1e-6)
        c = trelight.render_mesh_flash(mesh_path, out_dir, tcam, light=30.0, light_pos=lp,
                                       assets=trelight.load_assets(mesh_path, out_dir))
        assert all(np.array_equal(b[k], c[k]) for k in b)
    env = jrelight.make_gradient_envmap()
    np.testing.assert_array_equal(env, trelight.make_gradient_envmap())
    a = jrelight.render_mesh_envmap(mesh_path, out_dir, jcam, env, n_theta=8, n_phi=16)
    b = trelight.render_mesh_envmap(mesh_path, out_dir, tcam, env, n_theta=8, n_phi=16)
    np.testing.assert_array_equal(a["mask"], b["mask"])
    np.testing.assert_allclose(b["color"], a["color"], rtol=1e-5, atol=1e-6)


def test_validate_mesh_on_a_jax_checkpoint(tmp_path):
    """The port's `train_volume --mode validate_mesh` resumes a checkpoint
    the JAX package wrote and extracts JAX's mesh: extract_geometry of
    -sdf_only on the same checkpoint, equal counts, vertices within 1e-4."""
    from iron_tpu_torch.data.synthetic import render_synthetic_dataset, write_scene_dir
    scene = write_scene_dir(render_synthetic_dataset("sphere", n_views=2, H=16, W=16,
                                                     device="cpu"), str(tmp_path / "scene"))
    conf = {"dataset": {"data_dir": scene},
            "model": {"sdf_network": {"d_out": 33, "d_hidden": 32, "n_layers": 4,
                                      "skip_in": [2], "multires": 4},
                      "rendering_network": {"d_feature": 32, "d_hidden": 32, "n_layers": 2,
                                            "skip_in": [], "multires": 0, "multires_view": 0},
                      "nerf": {"D": 2, "W": 32, "skips": []},
                      "neus_renderer": {"n_samples": 8, "n_importance": 8, "n_outside": 4,
                                        "up_sample_steps": 2}}}
    conf_path = str(tmp_path / "conf.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    jcfg = j_stage1_config(j_load_config(conf_path))
    params = to_np(j_init_stage1(jax.random.PRNGKey(7), jcfg))
    out_dir = str(tmp_path / "exp")
    j_save_checkpoint(out_dir, 12, params, None,
                      extra={"sdf_config": dataclasses.asdict(jcfg.sdf)})
    cli_volume.main(["--mode", "validate_mesh", "--conf", conf_path, "--out_dir", out_dir,
                     "--mcube_resolution", "40", "--device", "cpu"])
    got = tmesh.read_obj(os.path.join(out_dir, "mesh_0000012.obj"))
    ref = jmesh.extract_geometry(lambda p: -jsdf.sdf_only(params["sdf"], p, jcfg.sdf),
                                 resolution=40)
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape and len(ref[1]) > 500
    np.testing.assert_array_equal(got[1], ref[1])
    # write_obj keeps 6 decimals
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# the independent ground truth
# ---------------------------------------------------------------------------

def test_independent_gt_sphere_render_matches_jax():
    """render_independent_dataset of the sphere at 32x32 (2 views at focal 40,
    so the silhouette is in the frame; the GT mesh at 128^3): the mesh bit for bit, masks identical, the images and
    per-view renders within 1e-6 (each package's numpy, the native library
    built from one source)."""
    from iron_tpu.eval import independent_gt as jgt
    from iron_tpu_torch.eval import independent_gt as tgt
    kw = dict(n_views=2, H=32, W=32, mesh_resolution=128, rig_kwargs={"focal": 40.0})
    ref, got = jgt.render_independent_dataset("sphere", **kw), \
        tgt.render_independent_dataset("sphere", **kw)
    assert set(got) == set(ref) - {"cams"}
    for k in ("verts", "tris", "masks", "Ks", "W2Cs"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert 0.05 < got["masks"].mean() < 0.9 and got["images"].max() > 0.05
    np.testing.assert_allclose(got["images"], ref["images"], rtol=0, atol=1e-6)
    sdf_j, sdf_t = jgt.SCENES_NP["sphere"](), tgt.SCENES_NP["sphere"]()
    a = jgt.render_view_np(ref["verts"], ref["tris"], sdf_j, ref["Ks"][1], ref["W2Cs"][1], 32,
                           32, light=30.0)
    b = tgt.render_view_np(got["verts"], got["tris"], sdf_t, got["Ks"][1], got["W2Cs"][1], 32,
                           32, light=30.0)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("scene", ["sphere", "blobby", "torus", "genus2"])
def test_independent_gt_scene_sdfs_match_jax(scene):
    from iron_tpu.eval import independent_gt as jgt
    from iron_tpu_torch.eval import independent_gt as tgt
    p = np.random.default_rng(3).uniform(-1, 1, (4096, 3))
    np.testing.assert_array_equal(tgt.SCENES_NP[scene]()(p), jgt.SCENES_NP[scene]()(p))
    np.testing.assert_array_equal(tgt.sdf_normals_np(tgt.SCENES_NP[scene](), p),
                                  jgt.sdf_normals_np(jgt.SCENES_NP[scene](), p))


def test_independent_ggx_np_matches_the_port_brdf():
    """ggx_colocated_np (the port's numpy copy, equal to the JAX package's
    bit for bit) against the port's ggx_colocated at tests/test_brdf.py's
    hold (rtol 2e-4, atol 1e-5)."""
    from iron_tpu.eval import independent_gt as jgt
    from iron_tpu_torch.eval import independent_gt as tgt
    from iron_tpu_torch.shading.brdf import ggx_colocated
    g = np.random.default_rng(0)
    n = g.normal(size=(256, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = n + 0.3 * g.normal(size=(256, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    dist = g.uniform(1.0, 4.0, size=(256, 1)).astype(np.float32)
    da = g.uniform(0.1, 0.9, size=(256, 3)).astype(np.float32)
    sa = g.uniform(0.1, 0.9, size=(256, 3)).astype(np.float32)
    rough = g.uniform(0.05, 0.7, size=(256, 1)).astype(np.float32)
    indep = tgt.ggx_colocated_np(30.0, dist, n, v, da, sa, rough)
    ref = jgt.ggx_colocated_np(30.0, dist, n, v, da, sa, rough)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    ours = ggx_colocated(30.0, T(dist), T(n), T(v), {"diffuse_albedo": T(da),
                                                      "specular_albedo": T(sa),
                                                      "specular_roughness": T(rough)})
    for k in ("diffuse_rgb", "specular_rgb", "rgb"):
        np.testing.assert_array_equal(indep[k], ref[k], err_msg=k)
        np.testing.assert_allclose(ours[k].numpy(), indep[k], rtol=2e-4, atol=1e-5, err_msg=k)
