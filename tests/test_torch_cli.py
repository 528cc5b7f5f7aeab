"""The port's CLIs and their host modules against the JAX package on the
CPU: the config (womask_iron.json and its copy, field by field), the
logging helpers, the JPEG codec against OpenCV, the async checkpoints read
by the JAX package and the JAX package's pickles read by the port,
`preprocess` and `gen_jobs`, the user's whole two-stage workflow through
the port's CLIs with --device cpu (after tests/test_ingestion_cli.py), and
the import guard."""
import dataclasses
import filecmp
import functools
import glob
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax  # noqa: F401 (JAX on the CPU, as in every test_torch_* file)

from iron_tpu import config as jconfig
from iron_tpu.cli import gen_jobs as j_gen_jobs
from iron_tpu.cli import preprocess as j_preprocess
from iron_tpu.train.checkpoints import load_any_checkpoint as j_load_any_checkpoint
from iron_tpu.train.checkpoints import load_checkpoint as j_load_checkpoint
from iron_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint
from iron_tpu.utils import logging as jlogging

from iron_tpu_torch import config as tconfig
from iron_tpu_torch.cli import evaluate as cli_evaluate
from iron_tpu_torch.cli import gen_jobs as t_gen_jobs
from iron_tpu_torch.cli import preprocess as t_preprocess
from iron_tpu_torch.cli import train_surface as cli_surface
from iron_tpu_torch.cli import train_volume as cli_volume
from iron_tpu_torch.data import io as tio
from iron_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg
from iron_tpu_torch.data.synthetic import render_synthetic_dataset, write_scene_dir
from iron_tpu_torch.train.checkpoints import load_any_checkpoint, load_checkpoint
from iron_tpu_torch.utils import logging as tlogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONF = os.path.join(REPO, "iron_tpu", "configs", "womask_iron.json")
PORT_CONF = os.path.join(REPO, "iron_tpu_torch", "configs", "womask_iron.json")
# fields of the JAX package's configs the port leaves out (its products are
# f32, K3 at f32 class)
JAX_ONLY = {"Stage1Config": {"upsample_precision", "core_precision"}}


def _same_dataclass(a, b, path="cfg"):
    """Every field the two config dataclasses share equal, recursively; the
    JAX package's alone are exactly the listed ones."""
    name = type(a).__name__
    fa = {f.name for f in dataclasses.fields(a)}
    fb = {f.name for f in dataclasses.fields(b)}
    assert fa - fb == JAX_ONLY.get(name, set()), (path, fa - fb)
    assert not fb - fa, (path, fb - fa)
    for k in sorted(fa & fb):
        va, vb = getattr(a, k), getattr(b, k)
        if dataclasses.is_dataclass(va):
            _same_dataclass(va, vb, f"{path}.{k}")
        else:
            assert va == vb and type(va) is type(vb), (f"{path}.{k}", va, vb)


def test_config_matches_jax(tmp_path):
    """womask_iron.json and its copy are byte-identical, and both packages
    read it (and an override file) into the same config, field by field."""
    assert filecmp.cmp(JAX_CONF, PORT_CONF, shallow=False)
    _same_dataclass(jconfig.stage1_config_from_dict(jconfig.load_config_file(JAX_CONF, "c")),
                    tconfig.stage1_config_from_dict(tconfig.load_config_file(PORT_CONF, "c")))
    text = json.dumps({"general": {"base_exp_dir": "./exp/CASE_NAME/RGB_NAME/NIR_NAME"},
                       "train": {"batch_size": 64, "end_iter": 7},
                       "model": {"sdf_network": {"d_hidden": 32, "skip_in": [1, 2]},
                                 "neus_renderer": {"n_outside": 0}}})
    (tmp_path / "c.json").write_text(text)
    a = jconfig.load_config_file(str(tmp_path / "c.json"), "scene", nir_name="nir")
    b = tconfig.load_config_file(str(tmp_path / "c.json"), "scene", nir_name="nir")
    assert a == b and a["general"]["base_exp_dir"] == "./exp/scene/scene/nir"
    _same_dataclass(jconfig.stage1_config_from_dict(a), tconfig.stage1_config_from_dict(b))
    s2 = {"patch_size": 64, "surface": {"edge_budget": 512}, "sdf": {"skip_in": [3]}}
    _same_dataclass(jconfig.stage2_config_from_dict(s2), tconfig.stage2_config_from_dict(s2))
    with pytest.raises(KeyError, match="unknown config key"):
        tconfig.stage2_config_from_dict({"no_such_field": 1})


def test_logging_matches_jax(tmp_path):
    """concatenate_result bit for bit; ExperimentDir's args.txt and the
    metrics JSONL (but its clock) the same."""
    g = np.random.default_rng(0)
    imgs = [g.uniform(size=(4, 5, 3)).astype(np.float32), g.uniform(size=(4, 5)),
            g.uniform(size=(4, 5, 3)).astype(np.float32), g.uniform(size=(4, 5, 3))]
    for n in (2, 3):
        np.testing.assert_array_equal(jlogging.concatenate_result(imgs, n),
                                      tlogging.concatenate_result(imgs, n))
    args = {"conf": "a.json", "num_iters": 3, "lr": 0.5, "flag": True, "none": None,
            "obj": object.__name__, "list": [1, 2]}
    for lib, d in ((jlogging, "j"), (tlogging, "t")):
        exp = lib.ExperimentDir(str(tmp_path / d), args)
        exp.metrics.add_scalars(5, {"loss": np.float32(0.25), "psnr": 20.0}, prefix="s/")
        exp.metrics.close()
        assert exp.file("x") == str(tmp_path / d / "x")
    assert filecmp.cmp(tmp_path / "j" / "args.txt", tmp_path / "t" / "args.txt", shallow=False)
    recs = [json.loads(open(tmp_path / d / "logs" / "metrics.jsonl").read()) for d in "jt"]
    for r in recs:
        r.pop("t")
    assert recs[0] == recs[1] == {"step": 5, "s/loss": 0.25, "s/psnr": 20.0}


def _photo(g, H, W):
    """A smooth colour image with noise (a stand-in for a photograph)."""
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    base = np.stack([np.sin(6 * xx + 1) * 0.5 + 0.5, np.cos(4 * yy) * 0.5 + 0.5, xx * yy], -1)
    return (np.clip(base + 0.05 * g.normal(size=base.shape), 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(64, 64, 3), (37, 53, 3), (48, 80, 1)])
def test_jpeg_writer_against_opencv(shape):
    """The port's quality-95 baseline JPEG is OpenCV's own quality-95
    encode byte for byte (libjpeg's integer compressor;
    tests/test_torch_writers.py holds it at every height and quality)."""
    img = _photo(np.random.default_rng(1), *shape[:2])
    if shape[2] == 1:
        img = img[..., 0]
    ok, ref = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]) if img.ndim == 3 else img,
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok and encode_jpeg(img, 95) == ref.tobytes()


@pytest.mark.parametrize("flags", [[], [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
                                   [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444],
                                   [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], "gray"])
def test_jpeg_reader_against_opencv(tmp_path, flags):
    """A cv2-written JPEG (4:2:0, restart markers, 4:4:4, 4:2:2, gray) read
    by the port within 1/255 on average of cv2.imread; read_image and
    write_image through .jpg; the same image written progressive with the
    same flags read within 1/255 of cv2.imread too."""
    img = _photo(np.random.default_rng(2), 45, 61)
    path = str(tmp_path / "a.jpg")
    if flags == "gray":
        cv2.imwrite(path, img[..., 0])
        ref = np.repeat(cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., None], 3, -1)
    else:
        cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90] + flags)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    got = tio.read_image(path)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got * 255.0 - ref).mean() <= 1.0
    tio.write_image(str(tmp_path / "b.jpeg"), got)
    back = cv2.imread(str(tmp_path / "b.jpeg"), cv2.IMREAD_UNCHANGED)
    assert back.shape == ref.shape
    prog = str(tmp_path / "p.jpg")
    if flags == "gray":
        cv2.imwrite(prog, img[..., 0], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        ref = np.repeat(cv2.imread(prog, cv2.IMREAD_UNCHANGED)[..., None], 3, -1)
    else:
        cv2.imwrite(prog, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, 1] + flags)
        ref = cv2.imread(prog, cv2.IMREAD_UNCHANGED)[..., ::-1]
    with open(prog, "rb") as f:
        assert f.read()[2:].find(b"\xff\xc2") >= 0          # an SOF2 frame
    got = tio.read_image(prog)
    assert got.shape == ref.shape and np.abs(got * 255.0 - ref).mean() <= 1.0
    with open(str(tmp_path / "b.jpeg"), "rb") as f:
        assert decode_jpeg(f.read()).shape == ref.shape


def test_load_any_checkpoint_reads_jax_pickles_and_refuses_orbax(tmp_path):
    """A JAX pickle directory read by the port (the newest step); None where
    the JAX package returns None; the JAX package's orbax saves read as its
    load_any_checkpoint reads them: an older orbax step loses to the newest
    pickle, a newer one wins, and a step directory reads alone."""
    from iron_tpu.train.checkpoints import AsyncCheckpointer as JAsync
    g = np.random.default_rng(3)
    tree = {"sdf": {"layers": [{"v": g.normal(size=(3, 4)).astype(np.float32)}]}}
    for step in (3, 7):
        j_save_checkpoint(str(tmp_path / "exp"), step, tree, extra={"k": step})
    ck = load_any_checkpoint(str(tmp_path / "exp"))
    assert ck["step"] == 7 and ck["extra"] == {"k": 7}
    np.testing.assert_array_equal(ck["params"]["sdf"]["layers"][0]["v"],
                                  tree["sdf"]["layers"][0]["v"])
    assert load_any_checkpoint(str(tmp_path / "exp" / "ckpt_0000003.pkl"))["step"] == 3
    assert load_any_checkpoint(str(tmp_path / "missing")) is None
    os.makedirs(tmp_path / "empty")
    assert load_any_checkpoint(str(tmp_path / "empty")) is None
    assert j_load_any_checkpoint(str(tmp_path / "empty")) is None
    ckptr = JAsync(str(tmp_path / "exp"))
    trees = {s: {"sdf": {"layers": [{"v": jax.numpy.asarray(
        g.normal(size=(3, 4)).astype(np.float32))}]}} for s in (5, 9)}
    ckptr.save(5, trees[5], extra={"k": 5})
    ckptr.wait()
    assert load_any_checkpoint(str(tmp_path / "exp"))["step"] == 7   # older orbax step
    ckptr.save(9, trees[9], extra={"k": 9})
    ckptr.wait()
    for path in (str(tmp_path / "exp"), str(tmp_path / "exp" / "orbax" / "0000009")):
        got, ref = load_any_checkpoint(path), j_load_any_checkpoint(path)
        assert got["step"] == ref["step"] == 9 and got["extra"] == ref["extra"] == {"step": 9,
                                                                                   "k": 9}
        np.testing.assert_array_equal(got["params"]["sdf"]["layers"][0]["v"],
                                      np.asarray(ref["params"]["sdf"]["layers"][0]["v"]))
        np.testing.assert_array_equal(got["params"]["sdf"]["layers"][0]["v"],
                                      np.asarray(trees[9]["sdf"]["layers"][0]["v"]))


def test_async_checkpointer_copies_before_returning_and_raises_in_wait(tmp_path):
    """A save holds the tree as it was when save() returned, JAX reads it,
    and a write that fails raises in the next wait(), once."""
    from iron_tpu_torch.train.checkpoints import AsyncCheckpointer
    tree = {"a": np.arange(4, dtype=np.float32), "b": [np.ones((2, 2), np.float32)]}
    ck = AsyncCheckpointer(str(tmp_path / "ok"))
    path = ck.save(12, tree, extra={"k": np.float32(2.0)})
    tree["a"] += 1.0
    ck.wait()
    got = j_load_checkpoint(path)
    assert got["step"] == 12 and got["opt_state"] is None and got["extra"]["k"] == 2.0
    np.testing.assert_array_equal(got["params"]["a"], np.arange(4, dtype=np.float32))
    (tmp_path / "file").write_text("")
    bad = AsyncCheckpointer(str(tmp_path / "file"))
    bad.save(1, tree)
    with pytest.raises(FileExistsError):
        bad.wait()
    bad.wait()


def test_preprocess_and_gen_jobs_match_jax(tmp_path, capsys):
    """preprocess check / normalize / apply-alpha / make-masks on the same
    inputs give the JAX package's outputs (OpenCV there, the port's PNG
    codec here); gen_jobs writes the same scripts up to the module name."""
    data = render_synthetic_dataset("sphere", n_views=2, H=16, W=16, device="cpu")
    root = write_scene_dir(data, str(tmp_path / "scene"),
                           denormalize=(np.array([0.5, -1.0, 0.2]), 0.5))
    outs = []
    for lib in (j_preprocess, t_preprocess):
        lib.main(["check", "--image_dir", os.path.join(root, "image"),
                  "--cam_dict", os.path.join(root, "cam_dict_norm.json")])
        outs.append(capsys.readouterr().out)
        lib.main(["normalize", "--cam_dict", os.path.join(root, "cam_dict.json"),
                  "--out", str(tmp_path / f"{lib.__name__}.json")])
        capsys.readouterr()
    assert outs[0] == outs[1] and "OK: dataset is consistent" in outs[1]
    assert filecmp.cmp(tmp_path / "iron_tpu.cli.preprocess.json",
                       tmp_path / "iron_tpu_torch.cli.preprocess.json", shallow=False)

    g = np.random.default_rng(4)
    rgba = g.integers(0, 256, size=(2, 9, 7, 4), dtype=np.uint8)
    gray = g.integers(0, 3, size=(9, 7), dtype=np.uint8)
    for pkg in ("j", "t"):
        d = tmp_path / f"rgba_{pkg}"
        os.makedirs(d)
        for i in range(2):
            cv2.imwrite(str(d / f"{i}.png"), rgba[i])
        cv2.imwrite(str(d / "g.png"), gray)
        lib = j_preprocess if pkg == "j" else t_preprocess
        lib.main(["make-masks", "--image_dir", str(d), "--out_dir", str(tmp_path / f"m_{pkg}")])
        lib.main(["apply-alpha", "--image_dir", str(d)])
    for name in ("0.png", "1.png", "g.png"):
        for a, b in ((f"rgba_j/{name}", f"rgba_t/{name}"), (f"m_j/{name}", f"m_t/{name}")):
            np.testing.assert_array_equal(cv2.imread(str(tmp_path / a), cv2.IMREAD_UNCHANGED),
                                          cv2.imread(str(tmp_path / b), cv2.IMREAD_UNCHANGED))

    kw = dict(conf="c.json", data_dir="/data", exp_dir="/exp", extra_flags="--nir",
              gres="#SBATCH --gres=gpu:1")
    for slurm in (False, True):
        pj = j_gen_jobs.generate(["a", "b"], out_dir=str(tmp_path / f"j{slurm}"), slurm=slurm,
                                 **kw)
        pt = t_gen_jobs.generate(["a", "b"], out_dir=str(tmp_path / f"t{slurm}"), slurm=slurm,
                                 **kw)
        assert [os.path.basename(p) for p in pj] == [os.path.basename(p) for p in pt]
        for a, b in zip(pj + [os.path.join(os.path.dirname(pj[0]), "submit_all.sh")],
                        pt + [os.path.join(os.path.dirname(pt[0]), "submit_all.sh")]):
            ta, tb = open(a).read(), open(b).read()
            assert tb.count("iron_tpu_torch.cli.") == ta.count("iron_tpu.cli.")
            assert tb.replace("iron_tpu_torch.cli.", "iron_tpu.cli.") == \
                ta.replace(str(tmp_path / f"j{slurm}"), str(tmp_path / f"t{slurm}"))


# the narrow model of the dry run (tests/test_ingestion_cli.py's, with a
# background NeRF)
DRY_CONF = {
    "train": {"end_iter": 6, "batch_size": 64, "warm_up_end": 2, "anneal_end": 4,
              "val_freq": 6, "report_freq": 3, "save_freq": 3},
    "model": {"sdf_network": {"d_out": 33, "d_hidden": 32, "n_layers": 2, "skip_in": [],
                              "multires": 2},
              "rendering_network": {"d_feature": 32, "d_hidden": 32, "n_layers": 2,
                                    "skip_in": [], "multires": 0, "multires_view": 0},
              "nerf": {"D": 2, "W": 32, "skips": []},
              "neus_renderer": {"n_samples": 8, "n_importance": 8, "n_outside": 4,
                                "up_sample_steps": 2}}}


def test_two_stage_workflow_through_the_cli(tmp_path, monkeypatch, capsys):
    """The user's workflow through the port's CLIs on a scene folder, with
    --device cpu: preprocess check -> train_volume (6 steps, async saves) ->
    validate_mesh -> train_surface --neus_ckpt_fpath (3 steps, the final
    export at 32^3) -> --render_all -> evaluate images / mesh / relight.
    The material bake takes 1 x 20,000 samples into 128^2 atlases instead of
    5 x 500,000 into 1024^2 (CPU time); every other setting is the CLI's."""
    import iron_tpu_torch.export.materials as tmat
    monkeypatch.setattr(tmat, "export_materials",
                        functools.partial(tmat.export_materials, n_rounds=1,
                                          samples_per_round=20_000, texture_H=128,
                                          texture_W=128))
    data = render_synthetic_dataset("sphere", n_views=4, H=32, W=32, light=30.0, device="cpu")
    scene = write_scene_dir(data, str(tmp_path / "scene" / "train"))
    conf = dict(DRY_CONF, general={"base_exp_dir": str(tmp_path / "exp1")},
                dataset={"data_dir": scene, "folder_name": "image"})
    conf_path = str(tmp_path / "conf.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)

    t_preprocess.main(["check", "--image_dir", os.path.join(scene, "image"),
                       "--cam_dict", os.path.join(scene, "cam_dict_norm.json")])
    assert "OK: dataset is consistent" in capsys.readouterr().out
    cli_volume.main(["--mode", "train", "--conf", conf_path, "--num_iters", "6",
                     "--device", "cpu"])
    exp1 = str(tmp_path / "exp1")
    assert sorted(os.path.basename(p) for p in glob.glob(os.path.join(exp1, "ckpt_*.pkl"))) \
        == ["ckpt_0000003.pkl", "ckpt_0000006.pkl"]
    ck = j_load_checkpoint(os.path.join(exp1, "ckpt_0000006.pkl"))    # async, read by JAX
    assert ck["step"] == 6 and ck["extra"]["sdf_config"]["d_hidden"] == 32
    assert j_load_any_checkpoint(exp1)["step"] == 6
    assert os.path.isfile(os.path.join(exp1, "val_0000006.png"))
    cli_volume.main(["--mode", "validate_mesh", "--conf", conf_path, "--mcube_resolution", "32",
                     "--device", "cpu"])
    assert os.path.getsize(os.path.join(exp1, "mesh_0000006.obj")) > 0

    exp2 = str(tmp_path / "exp2")
    ckpt = os.path.join(exp1, "ckpt_0000006.pkl")
    cli_surface.main(["--data_dir", scene, "--out_dir", exp2, "--neus_ckpt_fpath", ckpt,
                      "--num_iters", "3", "--patch_size", "16", "--export_res", "32",
                      "--device", "cpu"])
    s2 = load_checkpoint(os.path.join(exp2, "ckpt_0000003.pkl"))
    assert s2["step"] == 3 and s2["opt_state"] is None
    assets = os.path.join(exp2, "mesh_and_materials_3")
    for name in ("mesh.obj", "mesh.mtl", "diffuse_albedo.png", "specular_albedo.png",
                 "roughness.png"):
        assert os.path.getsize(os.path.join(assets, name)) > 0, name
    assert tio.read_image(os.path.join(assets, "roughness.png")).max() > 0

    cli_surface.main(["--data_dir", scene, "--out_dir", exp2, "--neus_ckpt_fpath", ckpt,
                      "--render_all", "--device", "cpu"])
    renders = os.path.join(exp2, "render_train_3")
    jpgs = sorted(os.listdir(renders))
    assert len(jpgs) == 16 and all(j.endswith(".jpg") for j in jpgs)
    for j in jpgs[:4]:
        with open(os.path.join(renders, j), "rb") as f:
            raw = f.read()
        assert raw[:2] == b"\xff\xd8" and decode_jpeg(raw).shape == (32, 32, 3)
        assert cv2.imread(os.path.join(renders, j)).shape == (32, 32, 3)

    capsys.readouterr()
    cli_evaluate.main(["images", "--pred_dir", renders, "--gt_dir",
                       os.path.join(scene, "image"), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_images"] == 4 and np.isfinite(summary["psnr"])
    from iron_tpu_torch.export.mesh import extract_geometry, write_obj
    v, t = extract_geometry(lambda p: -(torch.linalg.norm(p, dim=-1) - 0.5), resolution=32,
                            device="cpu")
    write_obj(str(tmp_path / "gt.obj"), v, t)
    cli_evaluate.main(["mesh", "--mesh1", os.path.join(assets, "mesh.obj"),
                       "--mesh2", str(tmp_path / "gt.obj"), "--device", "cpu"])
    assert np.isfinite(json.loads(capsys.readouterr().out)["chamfer"])
    cli_evaluate.main(["relight", "--mesh", os.path.join(assets, "mesh.obj"),
                       "--materials", assets, "--cam_dict",
                       os.path.join(scene, "cam_dict_norm.json"),
                       "--out_dir", str(tmp_path / "relit"), "--device", "cpu"])
    assert len(os.listdir(tmp_path / "relit")) == 4

    # the validation mosaic of the stage-2 loop (every val_freq steps)
    from iron_tpu_torch.fields.sdf import SDFConfig
    from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer
    sdf_cfg = SDFConfig(**{**ck["extra"]["sdf_config"],
                           "skip_in": tuple(ck["extra"]["sdf_config"]["skip_in"])})
    tr = Stage2Trainer(Stage2Config(sdf=sdf_cfg), data["images"], data["Ks"], data["W2Cs"],
                       stage1_params=ck["params"], device="cpu")
    assert cli_surface.mosaic(tr, data["images"], 1).shape == (16, 24, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_volume.main(["--mode", "train", "--conf", conf_path, "--num_iters", "1"])


# the modules added or extended by the research trainers' slice
RESEARCH_MODULES = [f"iron_tpu_torch.{m}" for m in (
    "shading.tables", "shading.brdf", "shading.disney", "shading.materials",
    "train.checkpoints", "cli.train_surface", "train.curriculum",
    "train.stage1_multispectral", "fields.hashgrid", "train.nerf_runner",
    "eval.independent_gt", "utils.profiling", "utils.visualize")]


# the data-parallel slice's modules
DIST_MODULES = [f"iron_tpu_torch.dist.{m}" for m in ("mesh", "train", "dryrun")]


def test_train_volume_per_host_shard(tmp_path, monkeypatch, capsys):
    """train_volume --per_host_shard: one process loads every image; in a
    run of more than one process (torchrun's WORLD_SIZE) it exits with the
    usage error of the JAX CLI (iron_tpu/cli/train_volume.py:55-63), naming
    the port's dp step, before it loads anything."""
    data = render_synthetic_dataset("sphere", n_views=3, H=16, W=16, light=30.0, device="cpu")
    scene = write_scene_dir(data, str(tmp_path / "scene"))
    conf = dict(DRY_CONF, general={"base_exp_dir": str(tmp_path / "exp")},
                dataset={"data_dir": scene, "folder_name": "image"})
    conf_path = str(tmp_path / "conf.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    argv = ["--mode", "validate_image", "--conf", conf_path, "--per_host_shard",
            "--device", "cpu"]
    cli_volume.main(argv)
    assert "dataset 3 images (16, 16)" in capsys.readouterr().out
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        cli_volume.main(argv)
    assert e.value.code == 2
    assert "iron_tpu_torch.dist.train.make_dp_stage1_step" in capsys.readouterr().err


def test_train_surface_runs_the_multi_flavour(tmp_path):
    """`python -m iron_tpu_torch.cli.train_surface --renderer_name multi
    --device cpu` trains 2 narrow steps from a stage-1 checkpoint: the
    checkpoint holds the flavour's networks (the 4-way material_network)
    and finite parameters."""
    data = render_synthetic_dataset("sphere", n_views=2, H=32, W=32, light=30.0,
                                    rig_kwargs={"focal": 40.0}, device="cpu")
    scene = write_scene_dir(data, str(tmp_path / "scene" / "train"))
    from iron_tpu_torch.config import stage1_config_from_dict
    from iron_tpu_torch.data.dataset import RayDataset
    from iron_tpu_torch.train.stage1 import Stage1Trainer
    s1 = Stage1Trainer(stage1_config_from_dict(DRY_CONF),
                       RayDataset.from_arrays(data["images"], data["Ks"], data["W2Cs"],
                                              data["masks"], device="cpu"),
                       out_dir=str(tmp_path / "exp1"), device="cpu")
    s1.save()
    exp2 = str(tmp_path / "exp2")
    out = subprocess.run(
        [sys.executable, "-m", "iron_tpu_torch.cli.train_surface", "--data_dir", scene,
         "--out_dir", exp2, "--neus_ckpt_fpath", str(tmp_path / "exp1" / "ckpt_0000000.pkl"),
         "--renderer_name", "multi", "--num_iters", "2", "--patch_size", "16",
         "--skip_final_export", "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ck = load_checkpoint(os.path.join(exp2, "ckpt_0000002.pkl"))
    mats = ck["params"]["materials"]
    assert ck["step"] == 2 and "material_network" in mats and "metallic_network" not in mats
    for leaf in jax.tree_util.tree_leaves(ck["params"]):
        assert np.isfinite(leaf).all()


def test_port_imports_with_jax_and_the_jax_package_blocked():
    """Every module of iron_tpu_torch imports in a process where importing
    jax, optax, orbax or iron_tpu fails, the research trainers' and the
    data-parallel modules among them; there the orbax reader reads the
    committed fixture (tests/data_orbax) with its configs."""
    code = ("import pkgutil, sys\n"
            "for m in ('jax', 'optax', 'orbax', 'iron_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import iron_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(iron_tpu_torch.__path__,"
            " 'iron_tpu_torch.')]\n"
            "for n in names:\n"
            "    __import__(n)\n"
            "assert 'iron_tpu_torch.cli.train_surface' in names, names\n"
            f"assert not set({RESEARCH_MODULES + DIST_MODULES!r}) - set(names), names\n"
            "from iron_tpu_torch.train.checkpoints import read_orbax_checkpoint\n"
            "ck = read_orbax_checkpoint('tests/data_orbax/stage1/orbax/0000002')\n"
            "assert ck['step'] == 2 and ck['extra']['sdf_config']['d_hidden'] == 16\n"
            "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 40
