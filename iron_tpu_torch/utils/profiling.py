"""Profiling and numerical-debug switches (counterpart of
iron_tpu/utils/profiling.py):

  * `trace(log_dir)`: a torch.profiler trace of the block (CPU, and the
    CUDA device when there is one), written as a Chrome trace file;
  * `Timer`: wall-clock phase timing that synchronises the device of its
    `sync` tensors before reading the clock;
  * `debug_nans()`: raises FloatingPointError at the first operation,
    forward or backward, that yields a NaN (jax_debug_nans);
  * `checkify_fn(fn)`: fn -> (err, out), err None on a clean run, else the
    first failed check: a NaN or inf made by an operation, or an index out
    of range (checked before the gather runs, so a CUDA gather never reads
    out of bounds).

The checks run every PyTorch operation through a TorchDispatchMode and read
its outputs on the host: a debugging aid, slow by design.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (yielded) and write
    `<log_dir>/trace_<pid>_<ns>.json` (chrome://tracing or Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize(sync) -> None:
    """Wait for the devices of every CUDA tensor in `sync` (a tensor or a
    nested structure of them)."""
    for dev in {t.device for t in tree_flatten(sync)[0]
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Accumulating per-phase wall-clock timer."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        """Time the block; the devices of `sync` (a tensor or a nested
        structure of them) are waited for before the clock is read."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}


def _float_outputs(out):
    return [t for t in tree_flatten(out)[0]
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()]


class _CheckFailed(Exception):
    pass


_aten = torch.ops.aten


def _indexed(func, args):
    """(index tensor, the size of the dimension it indexes, whether negative
    indices count from the end) of each index argument of a gather op; []
    for other ops."""
    if func is _aten.index.Tensor:
        return [(i, args[0].shape[d], True) for d, i in enumerate(args[1]) if i is not None]
    if func in (_aten.index_select.default, _aten.gather.default):
        return [(args[2], args[0].shape[args[1]] if args[0].dim() else 1, False)]
    if func is _aten.take.default:
        return [(args[1], args[0].numel(), True)]
    if func is _aten.embedding.default:
        return [(args[1], args[0].shape[0], False)]
    return []


def _index_error(func, args) -> Optional[str]:
    """The out-of-range message of a gather op's arguments, or None."""
    for idx, size, wraps in _indexed(func, args):
        if idx.dtype == torch.bool or not idx.numel():
            continue
        lo, hi = int(idx.min()), int(idx.max())
        if lo < (-size if wraps else 0) or hi >= size:
            return f"index out of range in {func}: [{lo}, {hi}] for size {size}"
    return None


class _Checks(TorchDispatchMode):
    """Runs `on_fail(message)` at the first op that makes a NaN (or, with
    inf, an inf) or indexes out of range."""

    def __init__(self, on_fail: Callable[[str], None], inf: bool, index: bool):
        super().__init__()
        self.on_fail, self.inf, self.index = on_fail, inf, index

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.index:
            msg = _index_error(func, args)
            if msg:
                self.on_fail(msg)
        out = func(*args, **kwargs)
        for t in _float_outputs(out):
            if bool(torch.isnan(t).any()):
                self.on_fail(f"nan generated by {func}")
            if self.inf and bool(torch.isinf(t).any()):
                self.on_fail(f"inf generated by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise FloatingPointError at the first operation inside the block,
    forward or backward, that yields a NaN."""
    if not enable:
        yield
        return

    def fail(msg):
        raise FloatingPointError(msg)

    with _Checks(fail, inf=False, index=False):
        yield


def checkify_fn(fn):
    """fn -> a function returning (err, out): err None on a clean run, else
    a message naming the first failed check (a NaN or inf made by an
    operation, or an index out of range).  A NaN or inf is recorded and the
    run goes on; an index out of range stops it before the gather, and out
    is None."""
    def checked(*args, **kwargs):
        errors = []

        def fail(msg):
            if msg.startswith("index"):
                raise _CheckFailed(msg)
            if not errors:
                errors.append(msg)

        try:
            with _Checks(fail, inf=True, index=True):
                out = fn(*args, **kwargs)
        except _CheckFailed as e:
            return str(e), None
        return (errors[0] if errors else None), out

    return checked
