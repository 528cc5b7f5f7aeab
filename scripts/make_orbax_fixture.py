"""Write tests/data_orbax/: a stage-1 run of the JAX package saved through
its default async checkpointer (orbax), at a narrow width, for the port's
orbax reader (iron_tpu_torch/train/checkpoints.py::read_orbax_checkpoint)
to be held against on a machine without JAX (chip_smoke.py phase 8h).

    JAX_PLATFORMS=cpu python scripts/make_orbax_fixture.py

Trains 2 steps of iron_tpu's Stage1Trainer (async_ckpt, the JAX CLI's
default) on the analytic sphere and saves, then writes beside the run the
same checkpoint as the JAX package's pickle (`stage1_step2.pkl`: params,
optax state, step, extra), which the port reads without orbax.  Run on the
CPU; it imports JAX, so it is not part of the port.
"""
from __future__ import annotations

import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# the narrow networks of the fixture: SDF 3 x 16, colour 2 x 16, NeRF 2 x 16
SDF = dict(d_out=17, d_hidden=16, n_layers=3, skip_in=(), multires=2)
COLOR = dict(d_feature=16, mode="idr", d_in=9, d_out=3, d_hidden=16, n_layers=2, multires=2,
             multires_view=2, squeeze_out=True, skip_in=())
NERF = dict(D=2, W=16, skips=(0,), multires=2, multires_view=2)
RENDER = dict(n_samples=8, n_importance=8, n_outside=4, up_sample_steps=2, perturb=1.0)
STEPS = 2


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import pickle

    import jax
    import numpy as np

    from iron_tpu.data.dataset import RayDataset
    from iron_tpu.data.synthetic import render_synthetic_dataset
    from iron_tpu.fields.nerf import NeRFConfig
    from iron_tpu.fields.rendering import RenderingConfig
    from iron_tpu.fields.sdf import SDFConfig
    from iron_tpu.train.checkpoints import AsyncCheckpointer
    from iron_tpu.train.stage1 import Stage1Config, Stage1Trainer
    from iron_tpu.volume.integrator import NeuSRenderConfig

    out = os.path.join(HERE, "tests", "data_orbax")
    run = os.path.join(out, "stage1")
    shutil.rmtree(run, ignore_errors=True)
    scene = render_synthetic_dataset("sphere", n_views=2, H=32, W=32, light=30.0,
                                     rig_kwargs={"focal": 40.0})
    ds = RayDataset.from_arrays(scene["images"], scene["Ks"], scene["W2Cs"], scene["masks"])
    cfg = Stage1Config(sdf=SDFConfig(**SDF), color=RenderingConfig(**COLOR),
                       nerf=NeRFConfig(**NERF), render=NeuSRenderConfig(**RENDER),
                       batch_size=32, warm_up_end=4, end_iter=100, anneal_end=10,
                       async_ckpt=True)
    tr = Stage1Trainer(cfg, ds, key=jax.random.PRNGKey(0), out_dir=run)
    tr.run(num_iters=STEPS, seed=0, steps_per_call=1)
    tr.save()
    tr.wait_for_saves()
    ck = AsyncCheckpointer(run).restore(target={"params": tr.params, "opt_state": tr.opt_state})
    payload = {"params": jax.tree_util.tree_map(np.asarray, ck["params"]),
               "opt_state": jax.tree_util.tree_map(np.asarray, ck["opt_state"]),
               "step": ck["step"], "extra": ck["extra"]}
    with open(os.path.join(out, f"stage1_step{STEPS}.pkl"), "wb") as f:
        pickle.dump(payload, f, protocol=4)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {out}: step {ck['step']}, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
