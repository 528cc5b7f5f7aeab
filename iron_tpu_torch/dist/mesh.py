"""Process groups and the (dp, tp) mesh (counterpart of
iron_tpu/dist/mesh.py).

The JAX package lays a (dp, tp) `jax.sharding.Mesh` over its devices and lets
XLA's partitioner insert the collectives.  Here every rank is one process
with one device, and the collectives are explicit `torch.distributed` calls
on the mesh's process groups:

  * `initialize_distributed` joins the group (torchrun's environment, or an
    explicit init_method / store), NCCL on CUDA and gloo on the CPU unless
    the caller names the backend;
  * `make_mesh(dp, tp)` returns a `Mesh`: the world's group, this rank, the
    world and the device, with `shape = {"dp": dp, "tp": tp}` as the JAX
    mesh has, ranks laid out as JAX's devices.reshape(dp, tp) lays them out
    (rank r at dp index r // tp, tp index r % tp), and with tp > 1 a process
    group for each axis (`dist.new_group`): the ranks of r's dp group share
    its tp index, those of its tp group its dp index;
  * `replicate` broadcasts rank 0's parameters and optimiser state in place
    (the counterpart of device_put(..., P()));
  * `shard_batch` takes this rank's rows of a leading axis (P("dp")).

One process without a group is a mesh of one rank whose collectives are the
identity.  NCCL takes one card a rank: ranks that would share a card raise
under it, and run under gloo, which moves CUDA tensors through the host.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from iron_tpu_torch import resolve_device

def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def process_index_count() -> Tuple[int, int]:
    """(rank, world size) of this process: the default group's once one is
    initialised, else torchrun's RANK and WORLD_SIZE, else (0, 1) (the
    counterpart of jax.process_index / jax.process_count)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return _env_int("RANK") or 0, _env_int("WORLD_SIZE") or 1


def initialize_distributed(backend: Optional[str] = None, device="cuda",
                           init_method: Optional[str] = None, store=None,
                           rank: Optional[int] = None, world_size: Optional[int] = None,
                           local_rank: Optional[int] = None, timeout: float = 120.0
                           ) -> torch.device:
    """Join the default process group and return this rank's device.

    rank / world_size / local_rank default to torchrun's RANK, WORLD_SIZE and
    LOCAL_RANK.  A single process (no WORLD_SIZE, no init_method or store)
    joins nothing, as jax.distributed.initialize does nothing there; nor does
    a process already in a group.  `backend` defaults to "nccl" on CUDA and
    "gloo" on the CPU, and is never switched: under NCCL, ranks that would
    share a card (a local rank at or beyond the device count, or more local
    ranks than cards) raise, naming backend="gloo".  On CUDA the rank's card
    is local_rank modulo the device count, pinned with torch.cuda.set_device.
    A collective that waits longer than `timeout` seconds for a lost rank
    fails instead of hanging."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' runs on CUDA devices; use backend='gloo' on the CPU")
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    local_rank = local_rank if local_rank is not None else _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank or 0
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local_world = _env_int("LOCAL_WORLD_SIZE") or 1
        if backend == "nccl" and (local_rank >= n_cards or local_world > n_cards):
            raise ValueError(
                f"local rank {local_rank} of {max(local_world, local_rank + 1)} on a host with "
                f"{n_cards} CUDA device(s): NCCL refuses two ranks on one device; pass "
                f"backend='gloo' for ranks that share a card")
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
    if dist.is_initialized() or (world_size is None and init_method is None and store is None):
        return dev
    if init_method is None and store is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=-1 if rank is None else rank,
                            world_size=-1 if world_size is None else world_size,
                            timeout=datetime.timedelta(seconds=timeout))
    return dev


@dataclasses.dataclass
class Mesh:
    """A (dp, tp) mesh: this rank's place in `group` (the world's; None:
    one rank, no group) and its device.  `shape` is {"dp": ..., "tp": ...}
    as the JAX mesh's; `groups` holds the process group of each axis of
    more than one rank when tp > 1 (with tp = 1 the dp axis is the world).
    The collectives act on tensors in place (or return new ones) along an
    axis and are the identity over one rank; under NCCL the tensors lie on
    the mesh's device."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    device: torch.device
    shape: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]] = dataclasses.field(default_factory=dict)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.shape["tp"]

    @property
    def tp_rank(self) -> int:
        return self.rank % self.shape["tp"]

    def _axis(self, axis: str) -> Optional[dist.ProcessGroup]:
        """The group of `axis` ("dp", "tp", or "world": every rank)."""
        if self.group is None or (axis != "world" and self.shape[axis] == 1):
            return None
        return self.group if axis == "world" or self.shape["tp"] == 1 else self.groups[axis]

    def all_reduce_sum(self, t: torch.Tensor, axis: str = "dp") -> torch.Tensor:
        """Sum t over the ranks of this rank's `axis` group ("dp", "tp" or
        "world"), in place; returns t."""
        group = self._axis(axis)
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's t on every rank of the world, in place; returns t."""
        if self.group is not None:
            dist.broadcast(t, src=0, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "dp", dim: int = 0) -> torch.Tensor:
        """The t of every rank of this rank's `axis` group (each of the same
        shape), in the group's order along `dim`."""
        group = self._axis(axis)
        if group is None:
            return t
        t = t.contiguous()
        n = self.size if axis == "world" else self.shape[axis]
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)


def make_mesh(dp: Optional[int] = None, tp: int = 1, device="cuda") -> Mesh:
    """The (dp, tp) mesh of the default group (or of this process alone):
    dp * tp ranks, dp = world / tp by default.  With tp > 1 every rank
    makes every axis group, in the same order (dist.new_group's rule)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tp < 1 or world % tp:
        raise ValueError(f"tp = {tp} does not divide the world of {world} ranks")
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"dp * tp = {dp * tp} != the world of {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(group=None, rank=0, size=1, device=dev, shape={"dp": 1, "tp": 1})
    rank = dist.get_rank()
    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    if tp > 1:
        for axis, members in (("tp", [[i * tp + j for j in range(tp)] for i in range(dp)]),
                              ("dp", [[i * tp + j for i in range(dp)] for j in range(tp)])):
            for ranks in members:
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[axis] = g
    return Mesh(group=dist.group.WORLD, rank=rank, size=world, device=dev,
                shape={"dp": dp, "tp": tp}, groups=groups)


def _state_tensors(obj) -> Iterator[torch.Tensor]:
    """The tensors `replicate` broadcasts, in an order fixed by the
    structure: a tensor, a module's parameters and buffers, or an
    optimiser's state (each parameter's entries by name; a GroupAdam
    through its Adam)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, torch.optim.Optimizer):
        for group in obj.param_groups:
            for p in group["params"]:
                st = obj.state.get(p, {})
                for k in sorted(st):
                    if isinstance(st[k], torch.Tensor):
                        yield st[k]
    elif isinstance(getattr(obj, "opt", None), torch.optim.Optimizer):
        yield from _state_tensors(obj.opt)
    else:
        raise TypeError(f"replicate takes a tensor, a module or an optimiser, not {type(obj)}")


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Rank 0's values of every tensor of `obj` (module parameters and
    buffers, optimiser state), broadcast in place to every rank; returns
    obj.  Every rank must hold the same structure (an optimiser with state
    for the same parameters): one all-reduce of the tensor counts checks it
    first, so a mismatch raises on every rank instead of hanging one."""
    tensors: List[torch.Tensor] = list(_state_tensors(obj))
    if mesh.group is None:
        return obj
    counts = mesh.all_gather(torch.tensor([len(tensors)], device=mesh.device), "world")
    if bool((counts != len(tensors)).any()):
        raise ValueError(f"replicate: the ranks hold {counts.tolist()} tensors; every rank "
                         f"must hold the same structure")
    for t in tensors:
        mesh.broadcast(t)
    return obj


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of the leading axis of a tensor or array: rows
    [r B/D, (r+1) B/D) for dp index r of D (replicated over tp).  The axis
    must divide by dp."""
    D = mesh.shape["dp"]
    n = batch.shape[0]
    if n % D:
        raise ValueError(f"a leading axis of {n} does not divide over dp={D}")
    b = n // D
    return batch[mesh.dp_rank * b:(mesh.dp_rank + 1) * b]
