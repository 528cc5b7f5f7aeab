"""Data-parallel training and rendering over torch.distributed (counterpart
of iron_tpu/dist/): one process a device, NCCL between cards, gloo on the CPU
or between ranks that share a card.  Run with `torchrun --nproc_per_node N`;
`python -m iron_tpu_torch.dist.dryrun` runs one step of each dp step."""
from iron_tpu_torch.dist.mesh import (Mesh, initialize_distributed, make_mesh,  # noqa: F401
                                      replicate, shard_batch)
from iron_tpu_torch.dist.train import (host_sharded_views,  # noqa: F401
                                       make_dp_stage1_render, make_dp_stage1_step,
                                       make_dp_stage2_render, make_dp_stage2_step,
                                       stage1_param_shardings)
