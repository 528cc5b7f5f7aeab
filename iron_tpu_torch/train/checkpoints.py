"""Checkpoints: the JAX package's `ckpt_*.pkl` files (pickled numpy
pytrees {"params", "opt_state", "step", "extra"}), written and read by both
packages, the conversion between their stage-2 parameter tree and the port's
modules, and the stage-1 -> stage-2 conversion (counterpart of
iron_tpu/train/checkpoints.py; its orbax checkpoints are not ported).

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
import os
import pickle
import re
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
from torch import nn

from iron_tpu_torch.fields.rendering import rendering_from_numpy, rendering_to_numpy
from iron_tpu_torch.fields.scalars import init_point_light
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_to_numpy
from iron_tpu_torch.shading.materials import renderer_network_configs


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
