#!/usr/bin/env python3
"""Bring-up check: the `fastk` counting pipeline end to end on one NVIDIA
GPU, at the size of FastK's headline job, a 50X HiFi genome survey at
k=40.

    python chip_smoke.py [--seed 0] [--genome-mb 20] [--coverage 50]
    python chip_smoke.py --mesh4      # four cards: the keyspace mesh only

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

0. Preflight: refuses any platform but "gpu"; prints the card's name and
   power limit (nvidia-smi, run before JAX touches the card), the device,
   the jax/jaxlib versions, the compile cache directory, whether the native
   host codec loaded, the in-core device memory budget, and checks that a
   device out-of-memory error is recognised as one.
1. Golden drives: the CLI drives of the CPU golden tests on
   tests/golden/inputs; .hist byte-identical to the committed goldens,
   .ktab byte-identical or, where the reference cut its hidden parts along
   its own thread partition, an identical stub and entry stream; .prof
   identical after decoding.
2. Plain reference at full device width: `-k40 -t1 -p` on one input that
   fills one device slice (2^26 positions), compared with the numpy counter
   of tests/util_refcount.py: histogram, table and every read's profile;
   then `-k40` on the same input (the single-slice hist_batch program)
   against the same histogram, with hist_batch's device time.
3. Full size, one card: a seeded 20 Mb genome at 50X in 20 kb reads with
   0.3% substitutions, half reverse-complemented (~1.0 Gbp), through
   `fastk -k40` (histogram), `-k40 -t3 -p -M12` (which the planner must send
   out-of-core) and `-k40 -t3 -p -M64` (in-core, budgeted from the card's
   memory_stats). The three .hist are byte-identical, the two tables
   byte-identical, the profiles identical, Σ c·hist[c] + overflow equals the
   40-mer instances counted from read lengths, and the table holds
   Σ_{c>=3} hist[c] entries. The out-of-core run goes before the in-core
   one because peak_bytes_in_use is a high-water mark for the process.
4. Placement: parallel/dist.py's routing step at the 4-card mesh's route
   size, timed on this card with its scatter placement and with the
   sort-based placement that scatter replaced.

Every output is an integer (k-mer keys, counts, histogram bins, profile
values) and no float matrix product is on the path, so TF32 plays no part:
all comparisons are exact equality, with no tolerance.

The last line of stdout is exactly
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}; every
number goes on an earlier line, prefixed with the card's name and power
limit. With --mesh4 the script builds the process-major mesh over four
local cards, runs parallel/meshooc.count_files_mesh with -t3 -p settings on
the phase-3 input, and compares it with a one-card in-core run in the same
process; it runs no other phase. Everything runs in this one process.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
K = 40

# (golden set, input, fastk flags): the drives tests/make_golden.sh ran
# through the reference FastK
GOLDEN_DRIVES = [
    ("tiny_k12_t1", "tiny.fasta", ["-k12", "-t1", "-p", "-T1"]),
    ("tiny_k12_t2", "tiny.fasta", ["-k12", "-t1", "-T2"]),
    ("small_k40", "small.fasta", ["-k40", "-t1", "-p", "-T4"]),
    ("small_k40_t3", "small.fasta", ["-k40", "-t3", "-T2"]),
    ("smallq_k32", "smallq.fastq", ["-k32", "-t1", "-p", "-T2"]),
    ("small_k40_c", "small.fasta", ["-k40", "-t1", "-p", "-T2", "-c"]),
]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    """Card name and power limit; nvidia-smi never touches JAX."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() \
        else "nvidia-smi not available"


def _fileset(base: str, ext: str):
    """{relative name: bytes} of a FastK file-set: the stub and its hidden
    parts (.ktab parts; .prof data and .pidx index parts)."""
    d, name = os.path.split(base)
    hidden = (f".{name}.{ext}.",) if ext != "prof" else \
        (f".{name}.prof.", f".{name}.pidx.")
    out = {}
    for f in sorted(os.listdir(d or ".")):
        if f == f"{name}.{ext}" or f.startswith(hidden):
            with open(os.path.join(d, f), "rb") as fh:
                out[f[len(name) + 1:] if f.startswith(name) else
                    f[len(name) + 2:]] = fh.read()
    return out


def _same_fileset(a: str, b: str, ext: str) -> bool:
    fa, fb = _fileset(a, ext), _fileset(b, ext)
    return bool(fa) and fa == fb


def _same_table(a: str, b: str) -> str:
    """"bytes" when the .ktab file-sets are byte-identical; "entries" when
    the stubs are and the entry streams decode identically but the entries
    fall into the hidden parts differently; "" otherwise."""
    import numpy as np

    from fastk_tpu.formats.ktab import read_ktab

    fa, fb = _fileset(a, "ktab"), _fileset(b, "ktab")
    if fa and fa == fb:
        return "bytes"
    ta, tb = read_ktab(a), read_ktab(b)
    if (fa.get("ktab") == fb.get("ktab") and ta.kmer == tb.kmer
            and np.array_equal(ta.packed, tb.packed)
            and np.array_equal(ta.counts, tb.counts)):
        return "entries"
    return ""


def _same_profiles(a: str, b: str) -> bool:
    """Decode-identical .prof file-sets (byte-identical ones trivially)."""
    import numpy as np

    from fastk_tpu.formats.prof import ProfileIndex

    if _same_fileset(a, b, "prof"):
        return True
    pa, pb = ProfileIndex(a), ProfileIndex(b)
    if pa.nreads != pb.nreads:
        return False
    return all(np.array_equal(pa.fetch(i), pb.fetch(i))
               for i in range(pa.nreads))


def _fastk(argv) -> None:
    from fastk_tpu.tools import fastk

    rc = fastk.main(list(argv))
    _check(rc == 0, f"fastk {' '.join(argv)} returned {rc}")


# -- phase 1 ---------------------------------------------------------------

def phase_golden(workdir: str, say) -> None:
    import numpy as np

    from fastk_tpu.formats.prof import ProfileIndex

    for name, inp, flags in GOLDEN_DRIVES:
        t0 = time.perf_counter()
        stem = inp.split(".")[0]
        out = os.path.join(workdir, "golden", name, stem)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        _fastk([*flags, f"-P{workdir}", f"-N{out}",
                os.path.join(GOLDEN, "inputs", inp)])
        ref = os.path.join(GOLDEN, name, stem)
        _check(_same_fileset(out, ref, "hist"), f"{name}: .hist bytes")
        # the reference cuts a table's hidden parts along its own thread
        # partition; where that differs from our even cut only the stub and
        # the entry stream compare (as tests/test_pipeline.py checks)
        how = _same_table(out, ref)
        _check(bool(how), f"{name}: .ktab")
        if "-p" in flags:
            _check(_same_profiles(out, ref), f"{name}: .prof decode")
        say(f"phase 1 golden {name} ({' '.join(flags)}): .hist bytes, .ktab "
            f"{how}{', .prof decode' if '-p' in flags else ''} identical, "
            f"{time.perf_counter() - t0:.3f} s")
    # relative profiles of smallq against small's golden table
    t0 = time.perf_counter()
    out = os.path.join(workdir, "golden", "rel", "smallq")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    table = os.path.join(GOLDEN, "small_k40", "small.ktab")
    _fastk(["-k40", f"-p:{table}", "-T2", f"-P{workdir}", f"-N{out}",
            os.path.join(GOLDEN, "inputs", "smallq.fastq")])
    ref = ProfileIndex(os.path.join(GOLDEN, "rel_smallq_vs_small", "smallq"))
    got = ProfileIndex(out)
    _check(got.nreads == ref.nreads and all(
        np.array_equal(got.fetch(i), ref.fetch(i))
        for i in range(ref.nreads)), "relative .prof decode")
    say(f"phase 1 golden rel_smallq_vs_small (-k40 -p:table -T2): identical, "
        f"{time.perf_counter() - t0:.3f} s")


# -- inputs ------------------------------------------------------------------

def _write_fasta(path: str, reads) -> None:
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n" % i)
            f.write(r)
            f.write(b"\n")


def _reads(seed: int, genome_len: int, coverage: float, read_len: int,
           n_rate: float = 0.0):
    """Seeded reads from tests/gen_data.py: a random genome sampled at
    `coverage` with 0.3% substitutions, half reverse-complemented."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    from gen_data import make_genome, sample_reads

    rng = np.random.default_rng(seed)
    genome = make_genome(rng, genome_len)
    return sample_reads(rng, genome, coverage, read_len, n_rate=n_rate,
                        err_rate=0.003)


def make_survey_input(workdir: str, seed: int, genome_mb: float,
                      coverage: float, read_len: int = 20_000):
    """The phase-3 input as one FASTA; returns (path, bases, instances)."""
    reads = _reads(seed, int(genome_mb * 1e6), coverage, read_len)
    path = os.path.join(workdir, "survey.fasta")
    _write_fasta(path, reads)
    bases = sum(len(r) for r in reads)
    ninst = sum(max(0, len(r) - K + 1) for r in reads)
    return path, bases, ninst


# -- phase 2 ---------------------------------------------------------------

def phase_reference(workdir: str, say, seed: int,
                    positions: int = 1 << 26, read_len: int = 20_000,
                    genome_len: int = 4_000_000) -> None:
    """`-k40 -t1 -p` on reads that fill one device slice of `positions`,
    against the numpy counter."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import numpy as np
    from util_refcount import codes_of, count_reads

    from fastk_tpu.formats.hist import Histogram, read_histogram
    from fastk_tpu.formats.ktab import read_ktab
    from fastk_tpu.formats.prof import ProfileIndex
    from fastk_tpu.ops.kmers import pad_needed

    # each read takes read_len codes plus one separator in the device stream
    nreads = (positions - pad_needed(K) - 4096) // (read_len + 1)
    reads = _reads(seed + 1, genome_len,
                   (nreads + 0.5) * read_len / genome_len, read_len,
                   n_rate=0.05)[:nreads]
    fasta = os.path.join(workdir, "ref.fasta")
    _write_fasta(fasta, reads)
    out = os.path.join(workdir, "ref")
    t0 = time.perf_counter()
    _fastk(["-k40", "-t1", "-p", f"-P{workdir}", f"-N{out}", fasta])
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = count_reads([codes_of(r) for r in reads], K)
    t_ref = time.perf_counter() - t0
    _check(read_histogram(out) == Histogram.from_bins(K, ref.hist,
                                                      ref.overflow),
           "phase 2: .hist vs numpy reference")
    tab = read_ktab(out)
    _check(np.array_equal(tab.packed, ref.packed)
           and np.array_equal(tab.counts, ref.counts),
           "phase 2: .ktab vs numpy reference")
    pi = ProfileIndex(out)
    _check(pi.nreads == len(reads) and all(
        np.array_equal(pi.fetch(i), ref.profiles[i])
        for i in range(len(reads))), "phase 2: .prof vs numpy reference")
    say(f"phase 2 reference: {len(reads)} reads, {ref.ninst} 40-mer "
        f"instances, {len(ref.counts)} distinct; hist, ktab and all "
        f"profiles identical; fastk {t_dev:.3f} s, numpy {t_ref:.3f} s")
    # the histogram-only job on the same slice takes hist_batch
    out = os.path.join(workdir, "ref_hist")
    _fastk(["-k40", f"-P{workdir}", f"-N{out}", fasta])
    _check(read_histogram(out) == Histogram.from_bins(K, ref.hist,
                                                      ref.overflow),
           "phase 2: hist-only .hist vs numpy reference")
    say(f"phase 2 hist-only (hist_batch): identical; device time "
        f"{_time_hist_batch(reads, positions) * 1e3:.3f} ms per "
        f"{positions}-position slice (median of 5)")


def _time_hist_batch(reads, size: int) -> float:
    """Device seconds of ops.count.hist_batch on the reads' code stream."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax
    import jax.numpy as jnp
    import numpy as np
    from util_refcount import codes_of

    from fastk_tpu.ops.count import hist_batch
    from fastk_tpu.ops.kmers import pad_needed

    stream = np.full(size + pad_needed(K), 4, dtype=np.uint8)
    o = 0
    for r in reads:
        stream[o: o + len(r)] = codes_of(r)
        o += len(r) + 1
    codes = jnp.asarray(stream)
    jax.block_until_ready(hist_batch(codes, K, size))
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(hist_batch(codes, K, size))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# -- phase 3 ---------------------------------------------------------------

class _Capture(io.TextIOBase):
    """Collects a run's -v output and notes when its first batch line
    appeared."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.parts = []
        self.first_batch = None

    def write(self, s: str) -> int:
        if self.first_batch is None and re.search(r"\bbatch 1\b", s):
            self.first_batch = time.perf_counter() - self.t0
        self.parts.append(s)
        return len(s)

    def text(self) -> str:
        return "".join(self.parts)


def _peak_bytes():
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def drive(label: str, flags, fasta: str, workdir: str) -> dict:
    """One `fastk` run in this process with -v; returns where the output
    went, which path the planner took, wall and set-up seconds, seconds
    spent compiling, and the process's peak device bytes after it."""
    import jax

    out = os.path.join(workdir, label, "survey")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    compile_s = [0.0]

    def on_event(event, secs, **_kw):
        if event == "/jax/core/compile/backend_compile_duration":
            compile_s[0] += secs

    jax.monitoring.register_event_duration_secs_listener(on_event)
    t0 = time.perf_counter()
    cap = _Capture(t0)
    try:
        with contextlib.redirect_stdout(cap), contextlib.redirect_stderr(cap):
            _fastk([*flags, "-v", f"-P{workdir}", f"-N{out}", fasta])
    except BaseException:
        sys.stderr.write(cap.text()[-4000:])
        raise
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    wall = time.perf_counter() - t0
    text = cap.text()
    ooc = re.search(r"out-of-core: <=|falling back to out-of-core", text)
    plan = re.search(r"measured dedup ratio[^\n]*", text)
    return dict(label=label, flags=list(flags), out=out,
                path="out-of-core" if ooc else "in-core",
                plan=plan.group(0) if plan else "static plan", wall=wall,
                setup=cap.first_batch, compile=compile_s[0],
                peak=_peak_bytes())


def check_full(hist_run: dict, ooc_run: dict, incore_run: dict,
               ninst: int, tmin: int = 3) -> int:
    """Phase-3 equalities; returns the table's entry count."""
    from fastk_tpu.formats.hist import read_histogram
    from fastk_tpu.formats.ktab import read_ktab

    a, c, b = hist_run["out"], ooc_run["out"], incore_run["out"]
    _check(_same_fileset(a, b, "hist") and _same_fileset(a, c, "hist"),
           "phase 3: .hist of the three runs byte-identical")
    _check(_same_fileset(b, c, "ktab"),
           "phase 3: in-core and out-of-core .ktab byte-identical")
    _check(_same_profiles(b, c),
           "phase 3: in-core and out-of-core .prof decode-identical")
    h = read_histogram(a)
    _check(h.total_instances() == ninst,
           f"phase 3: Σ c·hist[c] + overflow = {h.total_instances()}, "
           f"host counted {ninst} instances")
    nent = len(read_ktab(b))
    want = int(h.counts[tmin - h.low:].sum())
    _check(nent == want,
           f"phase 3: {nent} table entries, Σ_(c>={tmin}) hist[c] = {want}")
    return nent


def _report(say, r: dict, budget: int) -> None:
    setup = "not seen" if r["setup"] is None else f"{r['setup']:.3f} s"
    peak = r["peak"]
    peak = "not reported" if peak is None else \
        f"{peak} ({peak / budget:.3f} of the in-core budget {budget})"
    say(f"phase 3 {r['label']} (fastk {' '.join(r['flags'])}): path "
        f"{r['path']} ({r['plan']}), wall {r['wall']:.3f} s, until first "
        f"batch {setup}, compiling {r['compile']:.3f} s, process peak "
        f"device bytes {peak}")


def phase_full(workdir: str, say, fasta: str, ninst: int,
               budget: int) -> None:
    hist_run = drive("a", ["-k40"], fasta, workdir)
    _report(say, hist_run, budget)
    ooc_run = drive("c", ["-k40", "-t3", "-p"], fasta, workdir)
    _report(say, ooc_run, budget)
    _check(ooc_run["path"] == "out-of-core", "phase 3(c) went out-of-core")
    incore_run = drive("b", ["-k40", "-t3", "-p", "-M64"], fasta, workdir)
    _report(say, incore_run, budget)
    _check(incore_run["path"] == "in-core", "phase 3(b) stayed in-core")
    nent = check_full(hist_run, ooc_run, incore_run, ninst)
    say(f"phase 3 checks: hist x3, ktab and prof identical; {ninst} "
        f"instances accounted; {nent} table entries")


# -- phase 4 ---------------------------------------------------------------

def _sort_placement(flat, operands, n_slots: int):
    """The sort-based placement parallel/dist.py used before its scatter,
    kept here only to time against it: one merge sort of the records and
    one dummy per slot keyed by (slot, record first), then a stable 1-bit
    compaction that extracts the dummies in slot order."""
    import jax
    import jax.numpy as jnp

    size = flat.shape[0]
    keys = jnp.concatenate([
        2 * jnp.minimum(flat, n_slots).astype(jnp.int32),
        2 * jnp.arange(n_slots, dtype=jnp.int32) + 1])
    is_dummy = jnp.concatenate([
        jnp.zeros(size, jnp.uint8), jnp.ones(n_slots, jnp.uint8)])
    padded = [jnp.concatenate([op.astype(jnp.uint32),
                               jnp.zeros(n_slots, jnp.uint32)])
              for op in operands]
    out = jax.lax.sort((keys, is_dummy, *padded), num_keys=1,
                       is_stable=False)
    s_keys, s_dummy, s_ops = out[0], out[1], out[2:]
    starts = (s_keys >> 1 != jnp.roll(s_keys >> 1, 1)).at[0].set(True)
    filled = [jnp.where(starts, op, jnp.roll(op, 1)) for op in s_ops]
    comp = jax.lax.sort(((1 - s_dummy), *filled), num_keys=1, is_stable=True)
    return [c[:n_slots] for c in comp[1:]]


def phase_placement(say, size: int = 1 << 26, ndev: int = 4,
                    slack: float = 1.8, reps: int = 5) -> dict:
    """Device time of the mesh's routing step (_route_chip: destination
    sort, rank, placement into [ndev, cap] send lanes) for one chip's
    shard of `size` positions: with its scatter placement, and with the
    sort-based placement it replaced (results must agree)."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fastk_tpu.ops.kmers import canonical_kmers, pad_needed
    from fastk_tpu.parallel import dist

    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, size + pad_needed(K),
                                     dtype=np.uint8))
    words, invalid = jax.jit(canonical_kmers, static_argnums=(1, 2))(
        codes, K, size)
    w0 = np.asarray(words[0][: 1 << 20])
    spl = jnp.asarray(np.quantile(w0, np.arange(1, ndev) / ndev)
                      .astype(np.uint32))
    pos = jnp.arange(size, dtype=jnp.uint32)
    cap = int(size // ndev * slack)
    times, lanes = {}, {}
    for name, place in (("scatter", dist._place_slots),
                        ("sort (replaced)", _sort_placement)):
        with mock.patch.object(dist, "_place_slots", place):
            fn = jax.jit(lambda w, i, p, s: dist._route_chip(
                w, i, p, s, ndev, cap, size, carry_pos=True)[:3])
            out = jax.block_until_ready(fn(words, invalid, pos, spl))
        lanes[name] = [np.asarray(x) for x in jax.tree.leaves(out)]
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(words, invalid, pos, spl))
            ts.append(time.perf_counter() - t0)
        times[name] = float(np.median(ts))
        say(f"phase 4 placement {name}: median {times[name] * 1e3:.3f} ms "
            f"over {reps} runs (size {size}, ndev {ndev}, cap {cap})")
    a, b = lanes.values()
    _check(all(np.array_equal(x, y) for x, y in zip(a, b)),
           "phase 4: both placements give the same send lanes")
    return times


# -- four cards ------------------------------------------------------------

def phase_mesh4(workdir: str, say, fasta: str, ninst: int,
                est_bases: int) -> None:
    """count_files_mesh over the local cards against a one-card in-core run
    of the same input."""
    from fastk_tpu.formats.hist import write_histogram
    from fastk_tpu.parallel.meshooc import count_files_mesh, default_mesh

    mesh = default_mesh()
    D = mesh.devices.size
    # the CLI's settings at FastK's default -M12 (tools/fastk.py _run and
    # _run_mesh): batch bases, part cap and parts per chip
    batch_bases = min(256 << 20, int(12e9 / 24))
    part_cap = min(1 << 26, max(1 << 22, int(12e9) // 96))
    ppc = max(1, min(256, -(-est_bases // (D * part_cap))))
    out = os.path.join(workdir, "mesh", "survey")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    res = count_files_mesh([fasta], K, mesh=mesh, table_min=3,
                           profiles=True, batch_bases=batch_bases,
                           sort_path=workdir, out_base=out, out_nparts=4,
                           part_cap=part_cap, parts_per_chip=ppc)
    write_histogram(out, res.hist)
    wall = time.perf_counter() - t0
    st = res.mesh_stats
    say(f"mesh4: {D} cards, wall {wall:.3f} s, all_to_all bytes "
        f"{st['a2a_bytes']}, spilled records {st['total_spilled']}, "
        f"retrains {st['retrains']}, slack escalations "
        f"{st['slack_escalations']}, round splits {st['batch_splits']}")
    one = drive("one", ["-k40", "-t3", "-p", "-M64"], fasta, workdir)
    say(f"mesh4 one-card run: path {one['path']}, wall {one['wall']:.3f} s")
    _check(res.hist.total_instances() == ninst, "mesh4: instance sum")
    _check(_same_fileset(out, one["out"], "hist"), "mesh4: .hist bytes")
    _check(_same_fileset(out, one["out"], "ktab"), "mesh4: .ktab bytes")
    _check(_same_profiles(out, one["out"]), "mesh4: .prof decode")
    say("mesh4: hist, ktab and prof identical to the one-card run")


# -- main ------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-mb", type=float, default=20.0)
    ap.add_argument("--coverage", type=float, default=50.0)
    ap.add_argument("--mesh4", action="store_true",
                    help="run the 4-card keyspace mesh and its comparison")
    args = ap.parse_args(argv)

    smi = nvidia_smi()  # before JAX first touches the card
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: error: JAX found no GPU (platform "
              f"{devs[0].platform}); this check runs only on the card",
              file=sys.stderr)
        return 1
    if args.mesh4 and len(devs) != 4:
        print(f"chip_smoke: error: --mesh4 needs 4 cards, JAX sees "
              f"{len(devs)}", file=sys.stderr)
        return 1

    def say(msg: str) -> None:
        print(f"[{smi}] {msg}", flush=True)

    import jaxlib

    from fastk_tpu import native
    from fastk_tpu.jaxenv import device_memory_budget, is_device_oom

    dev = devs[0]
    print(f"card: {smi}", flush=True)
    say(f"device: {dev.platform} {dev.device_kind} x{len(devs)}; jax "
        f"{jax.__version__}, jaxlib {jaxlib.__version__}")
    say(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    t0 = time.perf_counter()
    lib = native.load()
    say("native codec: " + (f"loaded ({time.perf_counter() - t0:.3f} s "
                            "incl. build)" if lib is not None
                            else "NOT loaded, numpy fallback in use"))
    limit = dev.memory_stats()["bytes_limit"]
    budget = device_memory_budget()
    say(f"device memory: bytes_limit {limit}, in-core budget {budget}")
    try:
        import jax.numpy as jnp

        jax.block_until_ready(jnp.ones(limit + (1 << 30), jnp.uint8))
        raise RuntimeError("an allocation past bytes_limit succeeded")
    except Exception as e:  # the runtime's own out-of-memory error
        _check(is_device_oom(e), f"out-of-memory error recognised: {e}")
        say("out-of-memory error recognised: "
            + str(e).strip().splitlines()[0][:160])

    default = (args.genome_mb, args.coverage) == (20.0, 50.0)
    if not default:
        say(f"reduced: genome {args.genome_mb} Mb (default 20), coverage "
            f"{args.coverage}X (default 50)")

    workdir = os.path.join(ROOT, ".smoke")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        t0 = time.perf_counter()
        fasta, bases, ninst = make_survey_input(
            workdir, args.seed, args.genome_mb, args.coverage)
        say(f"input: {bases} bases, {ninst} 40-mer instances, generated "
            f"in {time.perf_counter() - t0:.3f} s (seed {args.seed})")
        if args.mesh4:
            phase_mesh4(workdir, say, fasta, ninst, os.path.getsize(fasta))
        else:
            t0 = time.perf_counter()
            phase_golden(workdir, say)
            say(f"phase 1 done in {time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            phase_reference(workdir, say, args.seed)
            say(f"phase 2 done in {time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            phase_full(workdir, say, fasta, ninst, budget)
            say(f"phase 3 done in {time.perf_counter() - t0:.3f} s")
            phase_placement(say)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
