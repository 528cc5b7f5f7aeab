"""The wide sweep of damaged files against cv2.imread: every format and
damage class of tests/damage_cases.py over many seeds (tests/
test_torch_damaged.py runs a few of each in Tier-1).  Prints, per format
and class, the cases whose port array is OpenCV's ("equal"), those where
cv2.imread gives None and the port raises NoImage ("refused"), those where
cv2.imread raises cv2.error on a size past its limits and the port raises
ImageSizeError ("too large"), the cases of damage_cases.UNREPRODUCIBLE the
port refuses with a named ValueError ("unreproducible (named)"), and any
other ("wrong", each listed; an exception other than a ValueError counts
as wrong too); exits non-zero if any is wrong.

    python scripts/sweep_damaged.py [--seeds 100] [--formats 'jpeg 4:2:0,png']
                                    [--kinds header] [--jobs 4]

Needs OpenCV (the reference) and PIL; runs on the CPU.
"""
from __future__ import annotations

import argparse
import collections
import multiprocessing
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("equal", "refused", "too large", "unreproducible", "wrong")


def _setup() -> None:
    sys.path.insert(0, os.path.join(HERE, "tests"))
    sys.path.insert(0, HERE)


def _run(job):
    """One (format, class) pair over its seeds -> (format, class, counts,
    the wrong cases)."""
    import damage_cases as D
    name, kind, nseeds = job
    ext = D.FORMATS[name][1]
    devnull = os.open(os.devnull, os.O_WRONLY)
    saved = os.dup(2)
    counts, wrong = collections.Counter(), []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in range(nseeds if D.seeded(name, kind) else 1):
            data = D.damaged(name, kind, seed)
            # libjpeg, libpng, libtiff and OpenCV report each damaged file on stderr
            os.dup2(devnull, 2)
            try:
                ref, got = D.outcome(os.path.join(tmp, "f" + ext), data)
                key = D.classify(name, kind, seed, ref, got)
                why = D.verdict(ref, got)
            except Exception as e:          # not a ValueError: the port crashed
                key, why = "wrong", f"raised {e!r:.200}"
            finally:
                os.dup2(saved, 2)
            counts[key] += 1
            if key == "wrong":
                wrong.append((name, kind, seed, why))
    os.close(devnull)
    os.close(saved)
    return name, kind, counts, wrong


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=100, help="seeds per format and class")
    ap.add_argument("--formats", default="", help="comma-separated names (default: all)")
    ap.add_argument("--kinds", default="", help="comma-separated damage classes (default: all)")
    ap.add_argument("--jobs", type=int, default=4, help="worker processes")
    args = ap.parse_args(argv)
    _setup()
    import damage_cases as D

    names = [n for n in args.formats.split(",") if n] or sorted(D.FORMATS)
    kinds = [k for k in args.kinds.split(",") if k] or list(D.DAMAGE)
    jobs = [(n, k, args.seeds) for n in names for k in kinds]
    total = collections.Counter()
    wrong = []
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(args.jobs, initializer=_setup) as pool:
        for name, kind, counts, bad in pool.imap(_run, jobs):
            total.update(counts)
            wrong += bad
            print(f"{name:28s} {kind:6s} {sum(counts.values()):4d} cases: "
                  + ", ".join(f"{k} {counts[k]}" for k in KEYS), flush=True)
    print(f"all: {sum(total.values())} cases: "
          + ", ".join(f"{k} {total[k]}" for k in KEYS) + f" ({time.time() - t0:.0f} s)")
    for w in wrong:
        print("  wrong:", w)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
