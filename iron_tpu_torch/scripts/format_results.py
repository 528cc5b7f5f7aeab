"""The quality rounds' result tables (counterpart of
scripts/format_r4_results.py and scripts/format_r5_results.py), printed
letter for letter as those print them.

    python -m iron_tpu_torch.scripts.format_results --round {r4,r5} [--results_dir DIR]

DIR defaults to the repo's results/, the JAX package's record; the port's
reports (results/torch/, written by `quality_runs`) carry `device` beside
the JAX keys and print in the same layout.  r4 reads every
quality_*_r4_independent.json of DIR: a row a scene (held-out PSNR,
SSIM, chamfer, each stage's rate and wall, the GT's source).  r5 reads
quality_{scene}_r5_{control,sil}.json for the torus, the sphere, the
blobby and the genus-2 scene: a row an arm (PSNR and chamfer at the end,
the best stage-2 checkpoint's chamfer, the best held-out checkpoint's PSNR
and chamfer), then each arm's chamfer trajectory and materials.  A report
without stage-2 checkpoints prints "-" where the JAX script raises.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS = os.path.join(REPO, "results")
R5_SCENES = ("torus", "sphere", "blobby", "genus2")
R5_ARMS = ("control", "sil")


def r4_table(results_dir: str = RESULTS) -> List[str]:
    """format_r4_results.py's lines."""
    rows = []
    for p in sorted(glob.glob(os.path.join(results_dir, "quality_*_r4_independent.json"))):
        with open(p) as fh:
            r = json.load(fh)
        s1, s2 = r.get("stage1", {}), r.get("stage2", {})
        rows.append(
            f"| {r['scene']} | {r['test_psnr']:.2f} | {r['test_ssim']:.4f} | "
            f"{r['chamfer']:.4f} | {s1.get('iters_per_s', 0):.1f} it/s "
            f"({s1.get('wall_s', 0) / 3600:.2f} h) | "
            f"{s2.get('rays_per_s', 0) / 1e3:.0f}k rays/s "
            f"({s2.get('wall_s', 0) / 60:.0f} min) | {r['gt_source']} |")
    return ["| scene | held-out PSNR | SSIM | Chamfer | stage-1 | stage-2 | GT |",
            "|---|---|---|---|---|---|---|", *rows]


def _r5_report(results_dir: str, scene: str, arm: str) -> Optional[Tuple[dict, dict]]:
    """(report, {stage-2 step: trajectory row}) of one arm, or None."""
    p = os.path.join(results_dir, f"quality_{scene}_r5_{arm}.json")
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        r = json.load(fh)
    traj = r.get("chamfer_trajectory", {})
    return r, {int(k.split("_")[1]): v for k, v in traj.items() if k.startswith("stage2_")}


def r5_table(results_dir: str = RESULTS) -> List[str]:
    """format_r5_results.py's lines."""
    arms = [(scene, arm, out) for scene in R5_SCENES for arm in R5_ARMS
            if (out := _r5_report(results_dir, scene, arm)) is not None]
    lines = ["| scene | arm | PSNR 50k | chamfer 50k | best chamfer (step) | "
             "best-ckpt PSNR (step) | chamfer @ best ckpt |",
             "|---|---|---|---|---|---|---|"]
    for scene, arm, (r, s2) in arms:
        best = r.get("best") or {}
        if s2:
            step = min(s2, key=lambda k: s2[k]["chamfer"])
            best_ch = f"{s2[step]['chamfer']:.4f} ({step})"
        else:
            best_ch = "-"
        lines.append(f"| {scene} | {arm} | {r.get('test_psnr'):.2f} | "
                     f"{r.get('chamfer'):.4f} | {best_ch} | "
                     + (f"{best.get('heldout_psnr'):.2f} ({best.get('step')}) | "
                        if best.get("heldout_psnr") else "- | ")
                     + (f"{best.get('chamfer'):.4f} |" if best.get("chamfer") else "- |"))
    lines.append("")
    for scene, arm, (r, s2) in arms:
        curve = " ".join(f"{k // 1000}k:{s2[k]['chamfer']:.4f}" for k in sorted(s2))
        lines.append(f"{scene}/{arm} trajectory: {curve}")
        m = r.get("materials")
        if m:
            lines.append(f"  materials: rough_err {m['roughness_abs_err']:.3f} "
                         f"light*diffuse rel {m['light_diffuse_product_rel_err']:.3f} "
                         f"chroma_l1 {m['diffuse_chroma_l1']:.3f}")
    return lines


TABLES = {"r4": r4_table, "r5": r5_table}


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Print a quality round's result table.")
    p.add_argument("--round", required=True, choices=sorted(TABLES))
    p.add_argument("--results_dir", default=RESULTS,
                   help="the reports' folder (default: the repo's results/, the JAX record)")
    args = p.parse_args(argv)
    text = "\n".join(TABLES[args.round](args.results_dir))
    print(text)
    return text


if __name__ == "__main__":
    main()
