"""Staged stage-2 curricula, the ModelBed schedule (counterpart of
iron_tpu/train/curriculum.py): training in phases with per-phase network
freezing,

  * "rgb"    (to 50k):  colour / diffuse and specular albedo / roughness /
                        point light, the SDF trainable;
  * "refrac" (to 80k):  the metallic and dielectric eta / k (and weight)
                        nets and the roughness, the SDF frozen;
  * "env"    (to 120k): env_light_network alone, shaded with use_env_light.

Each phase builds its own Stage2Trainer with the phase's `trainable` map,
and so a fresh optimizer (a GroupAdam of the trainable groups; the frozen
ones are left out and never change).  The parameters and the step carry
over from phase to phase; `stage1_params` applies before the first phase
only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from iron_tpu_torch import resolve_device
from iron_tpu_torch.train.stage2 import Stage2Config, Stage2Trainer, make_optimizer

_COMP_NETS = ("color_network", "diffuse_albedo_network", "specular_albedo_network",
              "specular_roughness_network", "point_light_network", "metallic_network",
              "dielectric_network", "metallic_eta_network", "metallic_k_network",
              "dielectric_eta_network", "env_light_network")


def _plan(trainable, use_env_light: bool) -> Dict:
    on = {"sdf": "sdf" in trainable}
    on.update({k: k in trainable for k in _COMP_NETS})
    return {"trainable": on, "use_env_light": use_env_light}


PHASE_PLANS: Dict[str, Dict] = {
    "rgb": _plan({"sdf", "color_network", "diffuse_albedo_network", "specular_albedo_network",
                  "specular_roughness_network", "point_light_network"}, False),
    "refrac": _plan({"specular_roughness_network", "metallic_network", "dielectric_network",
                     "metallic_eta_network", "metallic_k_network", "dielectric_eta_network"},
                    False),
    "env": _plan({"env_light_network"}, True),
}


@dataclass
class CurriculumPhase:
    name: str
    num_iters: int


class CurriculumTrainer:
    """Runs stage-2 phases with per-phase freezing, carrying the parameters
    and the step over.  Every phase's trainer is built on `device` (CUDA by
    default) from a torch.Generator seeded with `seed`, as the JAX package
    builds each from PRNGKey(0); from the second phase on its parameters are
    replaced by the carried ones."""

    def __init__(self, cfg: Stage2Config, images: np.ndarray, Ks: np.ndarray,
                 W2Cs: np.ndarray, phases: Optional[List[CurriculumPhase]] = None,
                 out_dir: Optional[str] = None, stage1_params: Optional[Dict] = None,
                 device="cuda", seed: int = 0):
        self.base_cfg = cfg
        self.images, self.Ks, self.W2Cs = images, Ks, W2Cs
        self.out_dir = out_dir
        self.phases = phases or [CurriculumPhase("rgb", 50_000),
                                 CurriculumPhase("refrac", 30_000),
                                 CurriculumPhase("env", 40_000)]
        self.stage1_params = stage1_params
        self.device = resolve_device(device)
        self.seed = seed
        self.params = None
        self.step = 0

    def phase_trainer(self, phase: CurriculumPhase) -> Stage2Trainer:
        """The phase's Stage2Trainer: its config (use_env_light), its
        trainable map, a fresh optimizer, and the carried parameters and
        step."""
        plan = PHASE_PLANS[phase.name]
        cfg = dataclasses.replace(self.base_cfg, use_env_light=plan["use_env_light"])
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        tr = Stage2Trainer(cfg, self.images, self.Ks, self.W2Cs, generator=gen,
                           out_dir=self.out_dir,
                           stage1_params=self.stage1_params if self.params is None else None,
                           trainable=plan["trainable"], device=self.device)
        if self.params is not None:
            tr.params = self.params
            tr.opt = make_optimizer(cfg, tr.params, plan["trainable"])
        tr.step = self.step
        return tr

    def run(self, iters_scale: float = 1.0, log_every: int = 0, seed: int = 0,
            history: Optional[list] = None) -> Dict[str, float]:
        """Every phase in turn, max(1, num_iters * iters_scale) steps each;
        each phase saves at its end when out_dir is set.  Returns the last
        phase's last metrics."""
        metrics = {}
        for phase in self.phases:
            tr = self.phase_trainer(phase)
            n = max(1, int(phase.num_iters * iters_scale))
            metrics = tr.run(num_iters=n, log_every=log_every, seed=seed, history=history)
            self.params = tr.params
            self.step = tr.step
            if self.out_dir:
                tr.save()
                tr.wait_for_saves()
        return metrics
