"""Checkpoints: the JAX package's `ckpt_*.pkl` files (pickled numpy
pytrees {"params", "opt_state", "step", "extra"}) and the conversion between
their parameter tree and the port's modules (counterpart of
iron_tpu/train/checkpoints.py).

The parameter tree is {"sdf": {"layers": [{"v", "g", "b"}, ...]},
"materials": {<net>: {"layers": [...]}, "point_light_network": {"light"}}},
with every weight stored [d_in, d_out]; the port's modules keep that layout,
so the conversion copies arrays as they are.
"""
from __future__ import annotations

import glob
import os
import pickle
import re
from typing import Dict, Optional

import numpy as np
from torch import nn

from iron_tpu_torch.fields.rendering import rendering_from_numpy, rendering_to_numpy
from iron_tpu_torch.fields.scalars import init_point_light
from iron_tpu_torch.fields.sdf import SDFConfig, sdf_from_numpy, sdf_to_numpy
from iron_tpu_torch.shading.materials import renderer_network_configs


def latest_checkpoint(out_dir: str) -> Optional[str]:
    """The numbered `ckpt_<step>.pkl` with the highest step (ckpt_best.pkl is
    a model-selection artifact, not a resume point)."""
    pat = re.compile(r"ckpt_(\d+)\.pkl$")
    paths = [p for p in glob.glob(os.path.join(out_dir, "ckpt_*.pkl")) if pat.search(p)]
    if not paths:
        return None
    return max(paths, key=lambda p: int(pat.search(p).group(1)))


def load_checkpoint(path: str) -> Dict:
    """Unpickle a checkpoint.  Only open files this program or the JAX
    package wrote: unpickling can run code."""
    with open(path, "rb") as f:
        return pickle.load(f)


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
