"""Observability: metrics writer, validation mosaics, experiment dirs (a
copy of iron_tpu/utils/logging.py, host numpy).

Replaces the reference's TensorBoard SummaryWriter scalars + mosaic dumps
(render_volume.py:504-510, render_surface.py:655-667, helper.py:28-47) and
the args.txt / source-backup convention (render_surface.py:105,
render_volume.py:565-576).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


class MetricsWriter:
    """Scalar logger: tensorboardX when available, JSONL always."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter
            self.tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            pass

    def add_scalars(self, step: int, scalars: Dict[str, float], prefix: str = ""):
        rec = {"step": step, "t": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}"
            rec[name] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(name, float(v), step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def concatenate_result(image_list: List[np.ndarray], imarray_length: int = 3
                       ) -> np.ndarray:
    """Tile images into a mosaic, grayscale promoted to RGB, short rows
    zero-padded (models/helper.py:28-47)."""
    rows, all_rows = [], []
    for img in image_list:
        if img.ndim == 2:
            img = np.tile(img[:, :, None], (1, 1, 3))
        rows.append(img)
        if len(rows) == imarray_length:
            all_rows.append(np.concatenate(rows, axis=1))
            rows = []
    if rows:
        while len(rows) < imarray_length:
            rows.append(np.zeros_like(rows[0]))
        all_rows.append(np.concatenate(rows, axis=1))
    return np.concatenate(all_rows, axis=0)


class ExperimentDir:
    """Experiment directory with an args.txt snapshot (render_surface.py:105)
    and optional source-code backup (render_volume.py:565-576)."""

    def __init__(self, out_dir: str, args: Optional[Dict] = None,
                 backup_code: bool = False):
        self.path = out_dir
        os.makedirs(out_dir, exist_ok=True)
        if args is not None:
            with open(os.path.join(out_dir, "args.txt"), "w") as f:
                json.dump({k: (v if isinstance(v, (int, float, str, bool, list,
                                                  tuple, type(None))) else str(v))
                           for k, v in args.items()}, f, indent=2, sort_keys=True)
        if backup_code:
            self.backup_sources()
        self.metrics = MetricsWriter(os.path.join(out_dir, "logs"))

    def backup_sources(self) -> None:
        """Copy the iron_tpu_torch package sources into <exp>/recording/."""
        import shutil
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        dst = os.path.join(self.path, "recording")
        for root, _, files in os.walk(pkg_root):
            rel = os.path.relpath(root, pkg_root)
            for f in files:
                if f.endswith((".py", ".cpp", ".json", ".cu", ".cuh")):
                    os.makedirs(os.path.join(dst, rel), exist_ok=True)
                    shutil.copyfile(os.path.join(root, f),
                                    os.path.join(dst, rel, f))

    def file(self, name: str) -> str:
        return os.path.join(self.path, name)
