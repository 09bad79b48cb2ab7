#!/usr/bin/env python
"""Driver-level wall differential: the reference FastK binary vs our CLI
on the SAME input and box, per job shape (BASELINE.md's north-star
framing: time-to-output vs FastK).

Prints one JSON line per config: {"config", "oracle_s", "ours_s",
"ratio_oracle_over_ours"} (ratio > 1 means we are faster).

The -t/-p shapes stream multi-GB intermediate spills device<->host; the
histogram shape (D2H = one 32KB histogram) is the transfer-light
configuration. Not measured on the H100. This parent never imports JAX:
each CLI run is a child, and the one process on the card while it runs.

Usage: python benchmarks/bench_e2e.py [--mb 300] [--fasta PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
ORACLE = "/tmp/fastk_oracle"


def wall(cmd, cwd):
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    assert r.returncode == 0, (cmd, r.stderr[-800:])
    return dt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=300)
    ap.add_argument("--fasta", default=None)
    args = ap.parse_args()
    if not os.path.exists(os.path.join(ORACLE, "FastK")):
        sys.exit("oracle not built; run tests/make_golden.sh first")

    import tempfile

    d = tempfile.mkdtemp(prefix="fke2e")
    if args.fasta:
        fasta = os.path.abspath(args.fasta)
    else:
        from validate_scale import make_fasta

        fasta = os.path.join(d, "in.fasta")
        make_fasta(fasta, args.mb << 20)

    configs = [("hist", []), ("hist+table", ["-t3"]),
               ("hist+table+profiles", ["-t3", "-p"])]
    for name, extra in configs:
        # best-of-2 BOTH sides: the second run gives the oracle a warm
        # page cache and ours a warm XLA compile cache (first-run remote
        # compiles of new shapes cost ~30-60s each on this rig; real
        # production runs amortize them)
        o = min(wall([os.path.join(ORACLE, "FastK"), "-k40", "-T4",
                      f"-P{d}", *extra, fasta], d) for _ in range(2))
        cold = warm = None
        for _ in range(2):
            u = wall([sys.executable, "-m", "fastk_tpu.tools.fastk",
                      "-k40", "-T4", f"-P{d}", *extra, fasta,
                      f"-N{d}/ours_{name}"], os.path.dirname(HERE))
            cold = u if cold is None else cold
            warm = u if warm is None else min(warm, u)
        print(json.dumps(dict(config=name, oracle_s=round(o, 1),
                              ours_cold_s=round(cold, 1),
                              ours_warm_s=round(warm, 1),
                              ratio_oracle_over_ours_warm=round(
                                  o / warm, 2))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
