#!/usr/bin/env python
"""Full-scale oracle differential: a 300M-base FASTA through BOTH the
oracle FastK (-k40 -t3 -p -T4) and our CLI, then compare everything —
.hist bytes, .ktab stub bytes, full table content, and decoded profiles
(sampled). 10x larger than anything in tests/; exercises the out-of-core
plan (the input exceeds the in-core footprint ceiling at -M12).

Not yet run on the H100. This parent never imports JAX while the CLI
child runs (it reads the outputs with the host-only format codecs after
the child has exited), so the child is the one process on the card.

Usage: python benchmarks/validate_scale.py [--mb 300] (needs
/tmp/fastk_oracle — see tests/make_golden.sh)."""

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
ORACLE = "/tmp/fastk_oracle"


def make_fasta(path: str, nbases: int, seed: int = 7) -> None:
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, max(nbases // 33, 1 << 16), dtype=np.uint8)
    L = 20000
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        done = i = 0
        while done < nbases:
            s = genome[int(rng.integers(0, len(genome) - L)):][:L].copy()
            err = rng.random(L) < 0.003
            s[err] = (s[err] + rng.integers(1, 4, int(err.sum()))) % 4
            f.write(b">r%d\n" % i)
            f.write(lut[s].tobytes())
            f.write(b"\n")
            done += L
            i += 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=300)
    args = ap.parse_args()
    if not os.path.exists(os.path.join(ORACLE, "FastK")):
        sys.exit("oracle not built; run tests/make_golden.sh first")

    d = tempfile.mkdtemp(prefix="fkscale")
    fasta = os.path.join(d, "in.fasta")
    make_fasta(fasta, args.mb << 20)

    # the BASELINE.md north-star differential: time-to-.ktab/.prof of the
    # reference FastK binary vs our CLI on the SAME input and box, both
    # timed as a user would (process wall). The oracle gets -T4 (its
    # default-ish); this box has 1 host core, which throttles BOTH sides'
    # host work (parse for us, everything for it).
    import json
    import time

    t0 = time.perf_counter()
    r = subprocess.run([os.path.join(ORACLE, "FastK"), "-k40", "-t3", "-p",
                        "-T4", f"-P{d}", "-v", fasta], cwd=d,
                       capture_output=True, text=True)
    t_oracle = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-800:]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "fastk_tpu.tools.fastk",
                        "-k40", "-t3", "-p", "-T4", f"-P{d}", "-v", fasta,
                        f"-N{d}/ours"],
                       cwd=os.path.dirname(HERE), capture_output=True,
                       text=True)
    t_ours = time.perf_counter() - t0
    assert r.returncode == 0, r.stderr[-800:]
    print(json.dumps(dict(
        metric="e2e wall-clock, FastK -k40 -t3 -p (reference binary vs our "
               f"CLI, {args.mb}MB FASTA, same box)",
        oracle_s=round(t_oracle, 1), ours_s=round(t_ours, 1),
        speedup_vs_oracle=round(t_oracle / t_ours, 2))), flush=True)

    import fastk_tpu as fk
    from fastk_tpu.formats.prof import ProfileIndex

    ob, ub = os.path.join(d, "in"), os.path.join(d, "ours")
    with open(ob + ".hist", "rb") as f1, open(ub + ".hist", "rb") as f2:
        assert f1.read() == f2.read(), ".hist differs"
    print("HIST-IDENTICAL")
    with open(ob + ".ktab", "rb") as f1, open(ub + ".ktab", "rb") as f2:
        assert f1.read() == f2.read(), ".ktab stub differs"
    print("KTAB-STUB-IDENTICAL")
    a, b = fk.read_ktab(ub), fk.read_ktab(ob)
    assert len(a.counts) == len(b.counts)
    assert np.array_equal(a.packed, b.packed)
    assert np.array_equal(a.counts, b.counts)
    print(f"table content equal ({len(a.counts)} entries)")
    pa, pb = ProfileIndex(ub), ProfileIndex(ob)
    assert pa.nreads == pb.nreads
    rng = np.random.default_rng(3)
    ids = np.concatenate(
        [[0, pa.nreads - 1], rng.integers(0, pa.nreads, 2000)])
    for i in ids:
        assert np.array_equal(pa.fetch(int(i)), pb.fetch(int(i))), i
    print(f"{len(ids)} profiles decode-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
