"""Bounded-host-memory demonstration: peak RSS of the full `fastk` CLI
(out-of-core -M path) as input size grows 10x.

The reference's defining claim is bounded memory at arbitrary input scale
(3.2 Tbp on 12 GB RAM, reference README.md:44-46). This measures our
equivalent: the streaming ingest + spill + streamed writers keep host RSS
~flat — dominated by one batch buffer + the runtime — while input grows.

Usage:  python benchmarks/bench_rss.py [--small MB] [--big MB] [-k K]
Runs each size in a fresh subprocess (ru_maxrss is process-lifetime max)
and prints a JSON line per run plus a PASS/FAIL flatness verdict:
peak_rss(big) - peak_rss(small) must be far below the naive retained cost
(~5 B/base: 1 B codes + 4 B positions) that the pre-streaming design paid.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

K = 40


def make_fasta(path: str, nbases: int, seed: int = 0,
               read_len: int = 20_000) -> None:
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        done = 0
        i = 0
        while done < nbases:
            n = min(read_len, nbases - done)
            seq = lut[rng.integers(0, 4, n)].tobytes()
            f.write(b">r%d\n%s\n" % (i, seq))
            done += n
            i += 1


def run_one(fasta: str, workdir: str, k: int) -> dict:
    """Run the CLI in a subprocess (CPU platform) and parse -v RSS."""
    code = (
        "import jax, sys\n"
        "jax.config.update('jax_platforms','cpu')\n"
        "from fastk_tpu.tools.fastk import main\n"
        "sys.exit(main(sys.argv[1:]))\n"
    )
    env = dict(os.environ)
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.expanduser("~/.cache/fastk_tpu_xla"))
    env.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    # small fixed batches: both runs then stream the same-size buffers and
    # the RSS delta isolates per-input retention (also keeps XLA:CPU sorts
    # fast enough to run this on a 1-core box)
    env.setdefault("FASTK_TPU_BATCH_BASES", str(4 << 20))
    out_base = os.path.join(workdir, "out")
    r = subprocess.run(
        [sys.executable, "-c", code, f"-k{k}", "-t1", "-v", "-M1",
         f"-P{workdir}", fasta, f"-N{out_base}"],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-2000:])
        raise SystemExit(f"run failed on {fasta}")
    m = re.search(r"([\d,]+)MB\s*$", r.stderr.strip().splitlines()[-1])
    rss_mb = int(m.group(1).replace(",", "")) if m else -1
    return {"input_bases": os.path.getsize(fasta),
            "peak_rss_mb": rss_mb}


def run_one_mesh(fasta: str, workdir: str, k: int) -> dict:
    """count_files_mesh on an 8-device CPU mesh in a subprocess: the
    scale-out path's per-host RSS must plateau exactly like the
    single-chip ooc path (owner-resident merges + per-chip spill; the
    old design allgathered every unique each round and grew with input)."""
    code = (
        "import os, sys, resource, json\n"
        "import jax\n"
        "jax.config.update('jax_platforms','cpu')\n"
        "from fastk_tpu.parallel.meshooc import count_files_mesh\n"
        "nb = os.path.getsize(sys.argv[1])\n"
        "cap = 1 << 23\n"  # small part cap so the plateau shows at MBs
        "ppc = max(1, -(-nb // (8 * cap)))\n"
        "out = count_files_mesh([sys.argv[1]], int(sys.argv[2]),"
        " table_min=1, profiles=True, batch_bases=4<<20,"
        " sort_path=sys.argv[3], out_base=sys.argv[3]+'/mesh',"
        " parts_per_chip=ppc, part_cap=cap)\n"
        "print(json.dumps({'rss_mb':"
        " resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1000}))\n"
    )
    env = dict(os.environ)
    # the child runs on the CPU (8 virtual devices); this parent never
    # imports JAX
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-c", code, fasta, str(k), workdir],
        capture_output=True, text=True, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-2000:])
        raise SystemExit(f"mesh run failed on {fasta}")
    rss_mb = json.loads(r.stdout.strip().splitlines()[-1])["rss_mb"]
    return {"input_bases": os.path.getsize(fasta), "peak_rss_mb": rss_mb}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[80, 240],
                    help="MB of bases per run; peak RSS plateaus once the "
                    "-M1 part cap is reached (~75MB input), so the two "
                    "largest sizes should peak ~equal while a naive "
                    "retain-everything design grows ~5B/base")
    ap.add_argument("-k", type=int, default=K)
    ap.add_argument("--mesh", action="store_true",
                    help="measure the 8-virtual-device scale-out path "
                    "(count_files_mesh with streamed outputs) instead of "
                    "the single-chip CLI")
    args = ap.parse_args()

    results = []
    for mb in args.sizes:
        with tempfile.TemporaryDirectory(prefix="fkrss") as d:
            fasta = os.path.join(d, "in.fasta")
            make_fasta(fasta, mb << 20)
            res = (run_one_mesh(fasta, d, args.k) if args.mesh
                   else run_one(fasta, d, args.k))
            res["label"] = f"{mb}MB"
            print(json.dumps(res))
            results.append(res)

    small, big = results[-2], results[-1]
    delta = big["peak_rss_mb"] - small["peak_rss_mb"]
    naive = 5 * (args.sizes[-1] - args.sizes[-2])  # ~5 B/base if retained
    verdict = "PASS" if delta < naive / 4 else "FAIL"
    print(json.dumps({
        "metric": "peak-RSS delta past the -M part-size plateau (ooc path)",
        "delta_mb": delta, "naive_retained_mb": naive,
        "verdict": verdict}))
    return 0 if verdict == "PASS" else 1


if __name__ == "__main__":
    main()
