"""The wide sweep of damaged files against cv2.imread: every format and
damage class of tests/damage_cases.py over many seeds (tests/
test_torch_damaged.py runs a few of each in Tier-1).  Prints, per format
and class, the cases whose port array is OpenCV's ("equal"), those where
cv2.imread gives None and the port raises NoImage ("refused"), and any
other ("wrong", with the first few listed); exits non-zero if any is
wrong.

    python scripts/sweep_damaged.py [--seeds 100] [--formats 'jpeg 4:2:0,png']

Needs OpenCV (the reference) and PIL; runs on the CPU.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=100, help="seeds per format and class")
    ap.add_argument("--formats", default="", help="comma-separated names (default: all)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, HERE)
    import damage_cases as D

    names = [n for n in args.formats.split(",") if n] or sorted(D.FORMATS)
    # libjpeg, libpng and OpenCV report each damaged file on stderr
    devnull = os.open(os.devnull, os.O_WRONLY)
    saved = os.dup(2)
    total = collections.Counter()
    wrong = []
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            ext = D.FORMATS[name][1]
            for kind in D.DAMAGE:
                seeds = range(args.seeds if D.seeded(name, kind) else 1)
                counts = collections.Counter()
                for seed in seeds:
                    data = D.damaged(name, kind, seed)
                    os.dup2(devnull, 2)
                    try:
                        ref, got = D.outcome(os.path.join(tmp, "f" + ext), data)
                    finally:
                        os.dup2(saved, 2)
                    v = D.verdict(ref, got)
                    key = v if v in ("equal", "refused") else "wrong"
                    counts[key] += 1
                    if key == "wrong":
                        wrong.append((name, kind, seed, v))
                total.update(counts)
                print(f"{name:28s} {kind:5s} {len(seeds):4d} cases: "
                      + ", ".join(f"{k} {counts[k]}" for k in ("equal", "refused", "wrong")),
                      flush=True)
    print(f"all: {sum(total.values())} cases: "
          + ", ".join(f"{k} {total[k]}" for k in ("equal", "refused", "wrong"))
          + f" ({time.time() - t0:.0f} s)")
    for w in wrong[:20]:
        print("  wrong:", w)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
