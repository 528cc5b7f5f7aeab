"""Structured config (counterpart of iron_tpu/config.py, on the port's
config dataclasses).

Config files are JSON with `CASE_NAME` (and `RGB_NAME` / `NIR_NAME`) string
substitution before parsing; every dataclass field can be overridden by a
nested key, e.g. {"train": {"batch_size": 512}, "model": {"neus_renderer":
{"n_samples": 64}}}, mirroring the reference conf sections.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from iron_tpu_torch.train.stage1 import Stage1Config
from iron_tpu_torch.train.stage2 import Stage2Config


def load_config_file(path: str, case: str = "", rgb_name: str = "",
                     nir_name: str = "") -> Dict[str, Any]:
    """Read a JSON config with CASE_NAME substitution (render_volume.py:29-37)."""
    with open(path) as f:
        text = f.read()
    text = text.replace("CASE_NAME", case)
    text = text.replace("RGB_NAME", rgb_name or case)
    text = text.replace("NIR_NAME", nir_name or case)
    return json.loads(text)


def _update_dataclass(dc, overrides: Dict[str, Any]):
    """Recursively apply dict overrides to a (frozen) dataclass; lists
    become tuples; an unknown key raises."""
    kwargs = {}
    fields = {f.name for f in dataclasses.fields(dc)}
    for k, v in overrides.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k!r} for {type(dc).__name__}")
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[k] = _update_dataclass(cur, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return dataclasses.replace(dc, **kwargs)


# conf section -> {conf key: dataclass field} (confs/womask_iron.conf)
_TRAIN_KEYS = ("learning_rate", "learning_rate_alpha", "end_iter", "batch_size", "warm_up_end",
               "anneal_end", "use_white_bkgd", "igr_weight", "mask_weight", "save_freq",
               "val_freq", "report_freq")
_SDF_KEYS = ("d_out", "d_in", "d_hidden", "n_layers", "skip_in", "multires", "bias", "scale",
             "geometric_init", "weight_norm")
_RENDER_KEYS = ("n_samples", "n_importance", "n_outside", "up_sample_steps", "perturb")
_NERF_KEYS = ("D", "W", "d_in", "d_in_view", "multires", "multires_view", "skips",
              "use_viewdirs")
_COLOR_KEYS = ("d_feature", "mode", "d_in", "d_out", "d_hidden", "n_layers", "multires",
               "multires_view", "squeeze_out", "skip_in", "weight_norm")


def stage1_config_from_dict(d: Dict[str, Any]) -> Stage1Config:
    """Stage1Config from a reference-shaped config dict (sections train and
    model as in confs/womask_iron.conf)."""
    train, model = d.get("train", {}), d.get("model", {})
    pick = lambda sec, keys: {k: v for k, v in sec.items() if k in keys}
    overrides: Dict[str, Any] = pick(train, _TRAIN_KEYS)
    if "sdf_network" in model:
        overrides["sdf"] = pick(model["sdf_network"], _SDF_KEYS)
    if "variance_network" in model and "init_val" in model["variance_network"]:
        overrides["variance_init"] = model["variance_network"]["init_val"]
    if "neus_renderer" in model:
        overrides["render"] = pick(model["neus_renderer"], _RENDER_KEYS)
    if "nerf" in model:
        overrides["nerf"] = pick(model["nerf"], _NERF_KEYS)
    if "rendering_network" in model:
        overrides["color"] = pick(model["rendering_network"], _COLOR_KEYS)
    return _update_dataclass(Stage1Config(), overrides)


def stage2_config_from_dict(d: Dict[str, Any]) -> Stage2Config:
    return _update_dataclass(Stage2Config(), d)
