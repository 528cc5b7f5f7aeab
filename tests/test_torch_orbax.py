"""The port's reader of the JAX package's orbax checkpoints
(iron_tpu_torch/train/checkpoints.py::read_orbax_checkpoint) on the CPU:
saves made by the JAX package's AsyncCheckpointer read bit for bit as its
restore(target=...) returns them (a stage-1 tree with its optax state, a
stage-2 tree), the committed fixture of scripts/make_orbax_fixture.py
against its pickle, both trainers resuming from an orbax run, train_surface
warm-started from an orbax run as from the same run's pickle, the reader
in a process where tensorstore, zstandard, jax, OpenCV and PIL cannot be
imported, the OCDBT and zarr readers (iron_tpu_torch/train/ocdbt.py)
against tensorstore on the stores it writes, and a full-width stage-1
save."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse fixture)
import jax
import optax

from iron_tpu.train.checkpoints import AsyncCheckpointer as JAsync
from iron_tpu.train.checkpoints import save_checkpoint as j_save_checkpoint

from iron_tpu_torch.data.dataset import RayDataset
from iron_tpu_torch.data.synthetic import render_synthetic_dataset, write_scene_dir
from iron_tpu_torch.fields.nerf import NeRFConfig
from iron_tpu_torch.fields.rendering import RenderingConfig
from iron_tpu_torch.fields.sdf import SDFConfig
from iron_tpu_torch.train.ocdbt import OcdbtError, OcdbtStore, read_zarr
from iron_tpu_torch.train.checkpoints import (ScaleByAdamState, ScaleByScheduleState,
                                              load_checkpoint, params_to_numpy,
                                              read_orbax_checkpoint, resume_checkpoint)
from iron_tpu_torch.train.stage1 import (Stage1Config, Stage1Trainer, init_stage1_params,
                                         stage1_params_to_numpy)
from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer, init_stage2_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data_orbax")
NARROW = dict(d_out=33, d_hidden=32, n_layers=4, skip_in=(2,), multires=4)
COLOR = dict(d_feature=32, mode="idr", d_in=9, d_out=3, d_hidden=32, n_layers=4,
             multires=4, multires_view=2, squeeze_out=True, skip_in=(2,))
NERF = dict(D=2, W=32, skips=(0,))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_bit_equal(got, ref):
    """Leaf by leaf, the same paths (a sequence read as a tuple is the
    same path as a list), values, dtypes and shapes."""
    a, b = _leaves(got), _leaves(ref)
    assert set(a) == set(b), set(a) ^ set(b)
    for k, v in b.items():
        assert a[k].dtype == v.dtype and a[k].shape == v.shape, k
        np.testing.assert_array_equal(a[k], v, err_msg=k)


def _stage1_state(seed=0):
    """A stage-1 tree at the narrow width (the port's initialisation, as
    the JAX package's tree) and an optax Adam chain state of it, (Adam at
    count 2 with random moments, the schedule's count 2), as numpy."""
    cfg = Stage1Config(sdf=SDFConfig(**NARROW), color=RenderingConfig(**COLOR),
                       nerf=NeRFConfig(**NERF))
    params = stage1_params_to_numpy(init_stage1_params(cfg, torch.Generator().manual_seed(seed),
                                                       "cpu"))
    g = np.random.default_rng(seed)
    moment = lambda scale: jax.tree_util.tree_map(
        lambda x: np.asarray(scale * g.normal(size=x.shape), np.float32), params)
    square = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x * x), tree)
    opt = (optax.ScaleByAdamState(count=np.array(2, np.int32), mu=moment(0.1),
                                      nu=square(moment(1e-3))),
           optax.ScaleByScheduleState(count=np.array(2, np.int32)))
    return params, opt


def test_stage1_tree_with_optax_state_reads_as_jax_restores_it(tmp_path):
    """AsyncCheckpointer.save of a stage-1 tree and its optax Adam chain,
    read by the port without orbax: params and the two optax states bit-equal
    to restore(target=...) (as the stand-in NamedTuples), step and extra as
    restore returns them."""
    params, opt = _stage1_state()
    ckptr = JAsync(str(tmp_path))
    extra = {"sdf_config": {"d_hidden": 32}, "note": "x"}
    ckptr.save(12, params, opt, extra=extra)
    ckptr.wait()
    ref = ckptr.restore(target={"params": params, "opt_state": opt})
    got = read_orbax_checkpoint(str(tmp_path / "orbax" / "0000012"))
    assert got["step"] == ref["step"] == 12 and got["extra"] == ref["extra"]
    assert got["extra"] == {"step": 12, **extra}
    _assert_trees_bit_equal(got["params"], ref["params"])
    adam, sched = got["opt_state"]
    assert type(adam) is ScaleByAdamState and type(sched) is ScaleByScheduleState
    r_adam, r_sched = ref["opt_state"]
    np.testing.assert_array_equal(adam.count, np.asarray(r_adam.count))
    assert adam.count.dtype == np.asarray(r_adam.count).dtype and int(adam.count) == 2
    np.testing.assert_array_equal(sched.count, np.asarray(r_sched.count))
    _assert_trees_bit_equal(adam.mu, r_adam.mu)
    _assert_trees_bit_equal(adam.nu, r_adam.nu)
    assert isinstance(got["params"]["sdf"]["layers"], tuple)


def test_stage2_tree_reads_as_jax_restores_it(tmp_path):
    """A stage-2 tree (comp's material networks, the point light) saved
    without an optimizer state, as the JAX stage-2 trainer saves: bit-equal,
    opt_state None."""
    cfg = Stage2Config(renderer_name="comp", sdf=SDFConfig(**NARROW))
    params = params_to_numpy(init_stage2_params(cfg, torch.Generator().manual_seed(4), "cpu")[0])
    ckptr = JAsync(str(tmp_path))
    ckptr.save(3, params)
    ckptr.wait()
    ref = ckptr.restore(target={"params": params})
    got = read_orbax_checkpoint(str(tmp_path / "orbax" / "0000003"))
    assert got["opt_state"] is None and got["step"] == 3 and got["extra"] == {"step": 3}
    _assert_trees_bit_equal(got["params"], ref["params"])


def test_committed_fixture_reads_as_its_pickle():
    """tests/data_orbax (scripts/make_orbax_fixture.py: 2 steps of the JAX
    stage-1 trainer saved through its async checkpointer) against the same
    checkpoint as the JAX package's pickle, which the port reads without
    optax: every leaf of params and of the optax state bit-equal."""
    got = read_orbax_checkpoint(os.path.join(FIXTURE, "stage1", "orbax", "0000002"))
    ref = load_checkpoint(os.path.join(FIXTURE, "stage1_step2.pkl"))
    assert got["step"] == ref["step"] == 2 and got["extra"] == ref["extra"]
    _assert_trees_bit_equal(got["params"], ref["params"])
    for a, b in zip(got["opt_state"], ref["opt_state"]):
        assert type(a) is type(b)
        _assert_trees_bit_equal(a._asdict(), b._asdict())


def test_trainers_resume_from_jax_orbax_runs(tmp_path):
    """With async_ckpt, Stage1Trainer.resume reads the newest orbax step
    before the pickles (the JAX trainer's order): the parameters bit-equal,
    Adam seeded from optax's moments and counts; without async_ckpt the
    newest pickle.  Stage2Trainer.resume alike."""
    params, opt = _stage1_state(1)
    run = str(tmp_path / "s1")
    j_save_checkpoint(run, 20, jax.tree_util.tree_map(np.asarray, params), None)
    ckptr = JAsync(run)
    ckptr.save(8, params, opt)
    ckptr.wait()
    scene = render_synthetic_dataset("sphere", n_views=2, H=16, W=16, light=30.0, device="cpu")
    ds = RayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], device="cpu")
    cfg = Stage1Config(sdf=SDFConfig(**NARROW), color=RenderingConfig(**COLOR),
                       nerf=NeRFConfig(**NERF), async_ckpt=True)
    tr = Stage1Trainer(cfg, ds, out_dir=run, device="cpu")
    assert tr.resume() == 8 and tr.opt_count == 2
    _assert_trees_bit_equal(stage1_params_to_numpy(tr.params), params)
    _assert_trees_bit_equal(stage1_params_to_numpy(tr.params, lambda p: tr.opt.state[p]
                                                   ["exp_avg"]), opt[0].mu)
    _assert_trees_bit_equal(stage1_params_to_numpy(tr.params, lambda p: tr.opt.state[p]
                                                   ["exp_avg_sq"]), opt[0].nu)
    assert all(float(st["step"]) == 2 for st in tr.opt.state.values())
    m = tr.run(num_iters=1, steps_per_call=1)
    assert tr.step == 9 and all(np.isfinite(v) for v in m.values())
    sync = Stage1Trainer(Stage1Config(sdf=SDFConfig(**NARROW), color=RenderingConfig(**COLOR),
                                      nerf=NeRFConfig(**NERF)), ds, out_dir=run, device="cpu")
    assert sync.resume() == 20 and sync.opt_count == 0
    assert resume_checkpoint(str(tmp_path / "none"), orbax_first=True) is None

    c2 = Stage2Config(renderer_name="ggx", sdf=SDFConfig(**NARROW))
    p2 = params_to_numpy(init_stage2_params(c2, torch.Generator().manual_seed(5), "cpu")[0])
    run2 = str(tmp_path / "s2")
    ckptr2 = JAsync(run2)
    ckptr2.save(4, p2)
    ckptr2.wait()
    t2 = Stage2Trainer(Stage2Config(renderer_name="ggx", sdf=SDFConfig(**NARROW),
                                    async_ckpt=True),
                       scene["images"], scene["Ks"], scene["W2Cs"], out_dir=run2, device="cpu")
    assert t2.resume() == 4
    _assert_trees_bit_equal(params_to_numpy(t2.params), p2)


def test_train_surface_warm_starts_from_an_orbax_run(tmp_path):
    """train_surface --neus_ckpt_fpath on the fixture's orbax run directory
    and on its pickle: the stage-2 trainer starts from the same parameters
    (its step-0 checkpoints bit-equal), the stage-1 SDF adopted bit for bit
    with the narrow architecture from the run's extra."""
    from iron_tpu_torch.cli import train_surface
    scene = write_scene_dir(render_synthetic_dataset("sphere", n_views=2, H=24, W=24,
                                                     light=30.0, device="cpu"),
                            str(tmp_path / "scene"))
    saved = {}
    for label, ck in (("orbax", os.path.join(FIXTURE, "stage1")),
                      ("pickle", os.path.join(FIXTURE, "stage1_step2.pkl"))):
        out = str(tmp_path / label)
        train_surface.main(["--data_dir", scene, "--out_dir", out, "--neus_ckpt_fpath", ck,
                            "--renderer_name", "ggx", "--num_iters", "0", "--patch_size", "16",
                            "--skip_final_export", "--sync_ckpt", "--device", "cpu"])
        saved[label] = load_checkpoint(os.path.join(out, "ckpt_0000000.pkl"))["params"]
    _assert_trees_bit_equal(saved["orbax"], saved["pickle"])
    ref = load_checkpoint(os.path.join(FIXTURE, "stage1_step2.pkl"))["params"]["sdf"]
    _assert_trees_bit_equal(saved["orbax"]["sdf"], ref)


def test_reader_without_tensorstore_names_it_and_sync_ckpt(tmp_path):
    """Where tensorstore cannot be imported -- nor zstandard, jax, cv2 or
    PIL, as on the card's machine -- read_orbax_checkpoint,
    load_any_checkpoint (the step and the run directory),
    resume_checkpoint(orbax_first=True) and train_surface --neus_ckpt_fpath
    read the committed fixture bit-equal to its pickle, through the port's
    own OCDBT, zarr and zstd readers (the test's name is the one it had
    when the reader needed tensorstore and raised, naming it and
    --sync_ckpt)."""
    scene = write_scene_dir(render_synthetic_dataset("sphere", n_views=2, H=24, W=24,
                                                     light=30.0, device="cpu"),
                            str(tmp_path / "scene"))
    code = f"""
import sys, json
for m in ('tensorstore', 'zstandard', 'jax', 'cv2', 'PIL', 'optax', 'orbax', 'iron_tpu'):
    sys.modules[m] = None
import numpy as np
from iron_tpu_torch.train.checkpoints import (load_any_checkpoint, load_checkpoint,
                                              read_orbax_checkpoint, resume_checkpoint)
from iron_tpu_torch.cli import train_surface

def leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in leaves(v)]
    return [np.asarray(t)]

def same(a, b):
    a, b = leaves(a), leaves(b)
    return len(a) == len(b) and all(x.dtype == y.dtype and x.shape == y.shape
                                    and np.array_equal(x, y) for x, y in zip(a, b))

ref = load_checkpoint({os.path.join(FIXTURE, "stage1_step2.pkl")!r})
run = {os.path.join(FIXTURE, "stage1")!r}
got = {{"read": read_orbax_checkpoint(run + "/orbax/0000002"),
        "any_step": load_any_checkpoint(run + "/orbax/0000002"),
        "any_run": load_any_checkpoint(run),
        "resume": resume_checkpoint(run, orbax_first=True)}}
ok = {{k: same([v["params"], v["opt_state"]], [ref["params"], ref["opt_state"]])
       and v["step"] == ref["step"] and v["extra"] == ref["extra"] for k, v in got.items()}}
train_surface.main(["--data_dir", {scene!r}, "--out_dir", {str(tmp_path / "exp")!r},
                    "--neus_ckpt_fpath", run, "--renderer_name", "ggx", "--num_iters", "0",
                    "--patch_size", "16", "--skip_final_export", "--sync_ckpt",
                    "--device", "cpu"])
sdf = load_checkpoint({str(tmp_path / "exp" / "ckpt_0000000.pkl")!r})["params"]["sdf"]
ok["train_surface"] = same(sdf, ref["params"]["sdf"])
ok["blocked"] = [m for m in ('tensorstore', 'zstandard', 'jax', 'cv2', 'PIL')
                 if sys.modules.get(m) is not None]
print(json.dumps(ok))
"""
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "read": True, "any_step": True, "any_run": True, "resume": True,
        "train_surface": True, "blocked": []}


# ---------------------------------------------------------------------------
# the OCDBT and zarr readers against tensorstore
# ---------------------------------------------------------------------------

STORES = {
    "defaults": {},
    "inline_everything": {"max_inline_value_bytes": 1 << 20},
    "indirect_everything": {"max_inline_value_bytes": 0},
    "small_nodes": {"max_inline_value_bytes": 16, "max_decoded_node_bytes": 200,
                    "version_tree_arity_log2": 1},
    "uncompressed": {"compression": None, "max_decoded_node_bytes": 300},
    "zstd_level_9": {"compression": {"id": "zstd", "level": 9}, "max_decoded_node_bytes": 500},
    "zstd_negative": {"compression": {"id": "zstd", "level": -3}},
    "numbered": {"manifest_kind": "numbered", "max_decoded_node_bytes": 256},
}


def _write_kvstore(path, config, seed=0):
    """An OCDBT store written by tensorstore in several transactions (so
    several versions), with keys that share prefixes at several depths,
    empty and large values, some keys overwritten and some deleted; returns
    the store and the expected {key: value}."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(seed)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + str(path) + "/",
                          "config": config}).result()
    want = {}
    for batch in range(4):
        with ts.Transaction() as txn:
            for i in range(40):
                j = int(rng.integers(0, 90))
                key = b"params.layers.%d.%s/%d.%d" % (j % 9, b"vgb"[j % 3:j % 3 + 1], j, batch)
                if j % 11 == 0:
                    key = b"k%03d" % j
                value = rng.bytes(int(rng.choice([0, 3, 40, 300, 5000])))
                kv.with_transaction(txn).write(key, value).result()
                want[key] = value
        if batch == 2:
            for key in list(want)[::7]:
                kv.delete_range(ts.KvStore.KeyRange(key, key + b"\0")).result()
                del want[key]
    return kv, want


@pytest.mark.parametrize("name", sorted(STORES))
def test_ocdbt_reader_matches_tensorstore(tmp_path, name):
    kv, want = _write_kvstore(tmp_path / name, STORES[name], seed=len(name))
    listed = [k for k in kv.list().result()]
    store = OcdbtStore(str(tmp_path / name))
    assert store.list() == sorted(listed) == sorted(want)
    for key in listed:
        assert store.read(key) == kv.read(key).result().value == want[key]
    assert store.read(b"no such key") is None


def test_ocdbt_reader_refuses_a_corrupt_node(tmp_path):
    _write_kvstore(tmp_path / "s", {"max_inline_value_bytes": 1 << 20})
    store = OcdbtStore(str(tmp_path / "s"))
    path, offset, length = store.root[1:]
    with open(os.path.join(str(tmp_path / "s"), path), "r+b") as f:
        f.seek(offset + length - 6)
        b = f.read(1)
        f.seek(offset + length - 6)
        f.write(bytes([b[0] ^ 0x40]))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        OcdbtStore(str(tmp_path / "s")).list()


ZARRS = {
    "f4_chunks": dict(dtype="<f4", shape=[37, 50], chunks=[16, 20]),
    "f8_big_endian": dict(dtype=">f8", shape=[9, 4, 5], chunks=[4, 4, 2]),
    "i4_scalar": dict(dtype="<i4", shape=[], chunks=[]),
    "u2_fill": dict(dtype="<u2", shape=[30], chunks=[7], fill_value=513),
    "f4_nan_fill_raw": dict(dtype="<f4", shape=[10, 10], chunks=[3, 10], fill_value="NaN",
                            compressor=None),
    "b1_slash": dict(dtype="|b1", shape=[12, 5], chunks=[5, 5], dimension_separator="/"),
}


@pytest.mark.parametrize("name", sorted(ZARRS))
def test_zarr_arrays_match_tensorstore(tmp_path, name):
    """zarr v2 arrays written by tensorstore into an OCDBT store: several
    chunks with partial edge chunks, big-endian, a scalar, fill values for
    chunks never written, the null compressor, '/'-separated chunk keys."""
    ts = pytest.importorskip("tensorstore")
    spec = dict(ZARRS[name])
    metadata = {"zarr_format": 2, "order": "C", "filters": None,
                "compressor": spec.pop("compressor", {"id": "zstd", "level": 1}), **spec}
    base = "file://" + str(tmp_path / "s") + "/"
    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base},
                   "path": "a.b", "metadata": metadata}, create=True).result()
    rng = np.random.default_rng(7)
    full = (rng.normal(size=arr.shape) * 100).astype(arr.dtype.numpy_dtype)
    if name.endswith("fill") or name.endswith("fill_raw"):
        arr[2:4].write(full[2:4]).result()          # the other chunks stay unwritten
    else:
        arr.write(full).result()
    ref = arr.read().result()
    got = read_zarr(OcdbtStore(str(tmp_path / "s")), "a.b")
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_full_width_stage1_tree_reads_bit_equal(tmp_path):
    """A stage-1 tree at Stage1Config()'s shapes (SDF, colour net and NeRF
    8x256; 1,777,983 parameters) with optax Adam state of random leaves,
    saved through the JAX package's AsyncCheckpointer: the port's reader
    gives every leaf bit-equal to tensorstore's read (restore).  Its read
    time on the CPU is measured by scripts/time_orbax_read.py."""
    params = stage1_params_to_numpy(init_stage1_params(Stage1Config(),
                                                       torch.Generator().manual_seed(3), "cpu"))
    g = np.random.default_rng(3)
    rand = lambda scale: jax.tree_util.tree_map(
        lambda x: np.asarray(scale * g.normal(size=x.shape), np.float32), params)
    square = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x * x), tree)
    opt = (optax.ScaleByAdamState(count=np.array(9, np.int32), mu=rand(0.05),
                                  nu=square(rand(0.01))),
           optax.ScaleByScheduleState(count=np.array(9, np.int32)))
    n = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n == 1_777_983
    ckptr = JAsync(str(tmp_path))
    ckptr.save(9, params, opt)
    ckptr.wait()
    ref = ckptr.restore(target={"params": params, "opt_state": opt})
    got = read_orbax_checkpoint(str(tmp_path / "orbax" / "0000009"))
    _assert_trees_bit_equal(got["params"], ref["params"])
    for a, b in zip(got["opt_state"], ref["opt_state"]):
        _assert_trees_bit_equal(a._asdict(), b._asdict())
