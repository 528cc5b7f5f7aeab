"""Checkpoints: the JAX package's `ckpt_*.pkl` files (pickled numpy
pytrees {"params", "opt_state", "step", "extra"}), written and read by both
packages, the conversion between their stage-2 parameter tree and the port's
modules, and the stage-1 -> stage-2 conversion (counterpart of
iron_tpu/train/checkpoints.py).

Where the JAX package saves asynchronously through orbax, the port's
`AsyncCheckpointer` writes the same pickles on a background thread.  The
JAX package's orbax saves (`<out>/orbax/<step:07d>/`, zarr arrays in an
OCDBT key-value store, and `<step:07d>.extra.json`) are read by
`read_orbax_checkpoint` through the port's own OCDBT, zarr and zstd readers
(`ocdbt.py`, `zstd.py`), without jax, orbax, tensorstore or zstandard.
`load_any_checkpoint` and `resume_checkpoint` choose between the two kinds
as the JAX package does.

The stage-2 parameter tree is {"sdf": {"layers": [{"v", "g", "b"}, ...]},
"materials": {<net>: {"layers": [...]}, "point_light_network": {"light"}}},
with every weight stored [d_in, d_out]; the port's modules keep that layout,
so the conversion copies arrays as they are.  The stage-1 tree {"sdf",
"color", "variance"[, "nerf"]} is converted in train/stage1.py.

A JAX stage-1 checkpoint pickles optax's Adam state, (ScaleByAdamState(count,
mu, nu), ScaleByScheduleState(count)), by reference to optax's classes.
`load_checkpoint` reads those two classes as the stand-ins below, with the
same fields, so that it needs neither optax nor JAX; it maps no other class.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import pickle
import re
import threading
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
from torch import nn

from iron_tpu_torch.fields.rendering import rendering_from_numpy, rendering_to_numpy
from iron_tpu_torch.fields.scalars import init_point_light
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_to_numpy
from iron_tpu_torch.shading.materials import renderer_network_configs
from iron_tpu_torch.train.ocdbt import OcdbtStore, read_zarr


def save_checkpoint(out_dir: str, step: int, params, opt_state=None,
                    extra: Optional[Dict] = None) -> str:
    """Write `<out_dir>/ckpt_<step:07d>.pkl` atomically, in the JAX package's
    schema; params are the port's modules or a numpy tree, opt_state a
    numpy tree or None."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"ckpt_{step:07d}.pkl")
    if isinstance(params, nn.Module):
        params = params_to_numpy(params)
    payload = {"params": params, "opt_state": opt_state, "step": int(step),
               "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)
    return path


def latest_checkpoint(out_dir: str) -> Optional[str]:
    """The numbered `ckpt_<step>.pkl` with the highest step (ckpt_best.pkl is
    a model-selection artifact, not a resume point)."""
    pat = re.compile(r"ckpt_(\d+)\.pkl$")
    paths = [p for p in glob.glob(os.path.join(out_dir, "ckpt_*.pkl")) if pat.search(p)]
    if not paths:
        return None
    return max(paths, key=lambda p: int(pat.search(p).group(1)))


def _host_copy(tree):
    """A numpy tree with every array copied (a CPU tensor's .numpy() shares
    its storage, which the next optimizer step overwrites)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncCheckpointer:
    """Non-blocking checkpoints in save_checkpoint's schema: `save` copies
    the parameters (and optimizer state) to host numpy before it returns and
    writes `<out_dir>/ckpt_<step:07d>.pkl` on a background thread.  The next
    save, or `wait`, joins the one in flight and raises its error.  The
    thread is not a daemon: a save in flight completes before the
    interpreter exits."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, params, opt_state=None, extra: Optional[Dict] = None) -> str:
        self.wait()
        if isinstance(params, nn.Module):
            params = params_to_numpy(params)
        job = (self.out_dir, step, _host_copy(params), _host_copy(opt_state),
               _host_copy(extra))
        self._thread = threading.Thread(target=self._write, args=job, name="ckpt-save")
        self._thread.start()
        return os.path.join(self.out_dir, f"ckpt_{step:07d}.pkl")

    def _write(self, *job) -> None:
        try:
            save_checkpoint(*job)
        except Exception as e:      # raised again by wait(), in the caller's thread
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error


class ScaleByAdamState(NamedTuple):
    """Stand-in for optax's ScaleByAdamState in an unpickled checkpoint."""
    count: Any
    mu: Any
    nu: Any


class ScaleByScheduleState(NamedTuple):
    """Stand-in for optax's ScaleByScheduleState in an unpickled checkpoint."""
    count: Any


_OPTAX_STATES = {("optax._src.transform", "ScaleByAdamState"): ScaleByAdamState,
                 ("optax._src.transform", "ScaleByScheduleState"): ScaleByScheduleState}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _OPTAX_STATES:
            return _OPTAX_STATES[(module, name)]
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict:
    """Unpickle a checkpoint, optax's two state classes read as the
    stand-ins above.  Only open files this program or the JAX package wrote:
    unpickling can run code."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _rebuild(node):
    """The tree of (key_type, key) -> node maps: sequence keys (type 1)
    make tuples in index order, dict keys (type 2) dicts."""
    if not isinstance(node, dict):
        return node
    if node and all(t == 1 for t, _ in node):
        items = {int(k): v for (_, k), v in node.items()}
        return tuple(_rebuild(items.get(i)) for i in range(max(items) + 1))
    return {k: _rebuild(v) for (_, k), v in node.items()}


def _optax_state(state):
    """optax's Adam chain read as the stand-ins: an element with (count,
    mu, nu) is ScaleByAdamState, one with (count) alone
    ScaleByScheduleState; any other element stays as read."""
    def one(s):
        if isinstance(s, dict) and set(s) == {"count", "mu", "nu"}:
            return ScaleByAdamState(s["count"], s["mu"], s["nu"])
        if isinstance(s, dict) and set(s) == {"count"}:
            return ScaleByScheduleState(s["count"])
        return s
    return tuple(one(s) for s in state) if isinstance(state, tuple) else one(state)


def read_orbax_checkpoint(step_dir: str) -> Dict:
    """A step directory of the JAX package's AsyncCheckpointer
    (`<out>/orbax/<step:07d>/`) -> {"params", "opt_state", "step",
    "extra"} as numpy arrays, as its `restore` returns them: the tree from
    `_METADATA`'s tree_metadata (sequence keys as tuples), each leaf a zarr
    array of the OCDBT store (ocdbt.py); the step and the config dicts
    from `<step:07d>.extra.json`; optax's Adam state as the stand-ins above
    (opt_state None when the save has none)."""
    step_dir = os.path.abspath(os.path.normpath(step_dir))
    with open(os.path.join(step_dir, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{step_dir}: an orbax save without OCDBT or with zarr3 (use_ocdbt "
                         f"{meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')}); the "
                         f"port reads the JAX package's layout, OCDBT with zarr v2")
    store = OcdbtStore(step_dir)
    root: Dict = {}
    for entry in meta["tree_metadata"].values():
        keys = [(k["key_type"], k["key"]) for k in entry["key_metadata"]]
        name = ".".join(k for _, k in keys)
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = read_zarr(store, name)
    tree = _rebuild(root)
    extra: Dict = {}
    if os.path.exists(step_dir + ".extra.json"):
        with open(step_dir + ".extra.json") as f:
            extra = json.load(f)
    opt_state = tree.get("opt_state")
    return {"params": tree["params"],
            "opt_state": None if opt_state is None else _optax_state(opt_state),
            "step": int(extra.get("step", int(os.path.basename(step_dir)))), "extra": extra}


def orbax_steps(out_dir: str) -> List[int]:
    """The steps saved under `<out_dir>/orbax/`, ascending."""
    root = os.path.join(out_dir, "orbax")
    if not os.path.isdir(root):
        return []
    return sorted(int(p) for p in os.listdir(root)
                  if p.isdigit() and os.path.isdir(os.path.join(root, p)))


def _orbax_step_dir(out_dir: str, step: int) -> str:
    return os.path.join(out_dir, "orbax", f"{step:07d}")


def load_any_checkpoint(path: str) -> Optional[Dict]:
    """A checkpoint from a `ckpt_*.pkl` file, an orbax step directory, or
    an experiment directory holding either, where the newest step wins
    (orbax on a tie), as the JAX package's load_any_checkpoint; None when
    the path does not exist or holds no checkpoint."""
    if os.path.isfile(path):
        return load_checkpoint(path)
    if not os.path.isdir(path):
        return None
    norm = os.path.normpath(path)
    if os.path.basename(norm).isdigit() and os.path.basename(os.path.dirname(norm)) == "orbax":
        return read_orbax_checkpoint(norm)
    pkl = latest_checkpoint(path)
    pkl_step = int(re.search(r"ckpt_(\d+)\.pkl$", pkl).group(1)) if pkl else -1
    steps = orbax_steps(path)
    if steps and steps[-1] >= pkl_step:
        return read_orbax_checkpoint(_orbax_step_dir(path, steps[-1]))
    return load_checkpoint(pkl) if pkl else None


def resume_checkpoint(out_dir: str, orbax_first: bool) -> Optional[Dict]:
    """The checkpoint a trainer resumes from, as the JAX trainers choose
    it: with orbax_first (their async_ckpt) the newest orbax step, and when
    there is none, or it does not read (a warning), the newest numbered
    pickle."""
    if orbax_first:
        steps = orbax_steps(out_dir)
        if steps:
            step_dir = _orbax_step_dir(out_dir, steps[-1])
            try:
                return read_orbax_checkpoint(step_dir)
            except Exception as e:      # a partial or foreign save: the pickles
                logging.getLogger(__name__).warning(
                    "orbax restore of %s failed (%s); falling back to pickle checkpoints",
                    step_dir, e)
    pkl = latest_checkpoint(out_dir)
    return load_checkpoint(pkl) if pkl else None


def params_from_numpy(tree: Dict, device="cuda", sdf_cfg: SDFConfig = SDFConfig(),
                      renderer_name: str = "comp") -> nn.ModuleDict:
    """The port's stage-2 parameters {"sdf": SDFNetwork, "materials":
    ModuleDict} from the JAX parameter tree as numpy arrays.  Raises when the
    tree does not match `sdf_cfg` and the renderer's networks."""
    sdf = sdf_from_numpy(tree["sdf"], sdf_cfg, device)
    dims = sdf_cfg.dims
    expect = tuple(d - dims[0] if i in sdf_cfg.skip_in else d for i, d in enumerate(dims))
    got = tuple([sdf.layers[0].d_in] + [l.d_out for l in sdf.layers])
    if got != expect:
        raise ValueError(f"SDF parameters {got} do not match the config {sdf_cfg}")
    cfgs = renderer_network_configs(renderer_name, d_feature=sdf_cfg.d_out - 1)
    mats = tree["materials"]
    missing = set(cfgs) - set(mats)
    if missing:
        raise ValueError(f"material networks missing from the tree: {sorted(missing)}")
    nets = nn.ModuleDict({name: rendering_from_numpy(mats[name], cfg, device)
                          for name, cfg in sorted(cfgs.items())})
    nets["point_light_network"] = init_point_light(
        float(np.asarray(mats["point_light_network"]["light"])), device=device)
    return nn.ModuleDict({"sdf": sdf, "materials": nets})


def params_to_numpy(params: nn.ModuleDict) -> Dict:
    """Inverse of params_from_numpy: the JAX parameter tree as numpy arrays."""
    mats = {name: rendering_to_numpy(net) for name, net in params["materials"].items()
            if name != "point_light_network"}
    light = params["materials"]["point_light_network"].light
    mats["point_light_network"] = {"light": np.asarray(light.detach().cpu().numpy(),
                                                       np.float32)}
    return {"sdf": sdf_to_numpy(params["sdf"]), "materials": mats}


def stage1_to_stage2(stage1_params: Dict, stage2_params: Dict,
                     load_diffuse_albedo: bool = True) -> Dict:
    """Map a stage-1 numpy tree {sdf, color, ...} into a stage-2 numpy tree
    {sdf, materials}: the SDF as it is, and the stage-1 colour network as
    the diffuse albedo network when their layer shapes agree."""
    out = dict(stage2_params)
    out["sdf"] = stage1_params["sdf"]
    if load_diffuse_albedo and "color" in stage1_params:
        s1_layers = stage1_params["color"]["layers"]
        s2_layers = out["materials"]["diffuse_albedo_network"]["layers"]
        shape = lambda p: np.shape(p["v" if "v" in p else "w"])
        if len(s1_layers) == len(s2_layers) and all(
                shape(a) == shape(b) for a, b in zip(s1_layers, s2_layers)):
            out["materials"] = {**out["materials"],
                                "diffuse_albedo_network": stage1_params["color"]}
    return out
