"""The main `fastk` CLI — flag-parity with the reference FastK driver
(reference: FastK.c:223-561, usage README.md:67-69):

    fastk [-k<int(40)>] [-t[<int(1)>]] [-p[:<table>[.ktab]]] [-c] [-bc<int>]
          [-v] [-N<path_name>] [-P<dir($TMPDIR)>] [-M<int(12)>] [-T<int(4)>]
          <source>[.fast[aq][.gz]] ...

Produces <source>.hist always, <source>.ktab with -t, <source>.prof with -p.
With -p:<table>, only relative profiles are produced (reference
README.md:118-127).
"""

from __future__ import annotations

import os
import math
import resource
import sys
import time

from fastk_tpu.tools._cli import die, print_number, source_root

USAGE = """Usage: fastk [-k<int(40)>] [-t[<int(1)>]] [-p[:<table>[.ktab]]] [-c] [-bc<int>]
             [-v] [-N<path_name>] [-P<dir($TMPDIR)>] [-M<int(12)>] [-T<int(4)>]
                 <source>[.cram|.[bs]am|.db|.dam|.f[ast][aq][.gz] ..."""


def parse_argv(argv):
    cfg = dict(k=40, t=None, p=False, ptable=None, c=False, bc=0, v=False,
               N=None, P=os.environ.get("TMPDIR", "/tmp"), M=12, T=4,
               R=False, inputs=[])
    for a in argv:
        if a in ("-R", "--resume"):
            # staged restart (reference DEVELOPER mode, FastK.c:302-315):
            # keep the out-of-core spill on failure and re-enter after the
            # last completed batch on rerun
            cfg["R"] = True
        elif a.startswith("-k"):
            cfg["k"] = int(a[2:])
        elif a == "-t":
            cfg["t"] = 1
        elif a.startswith("-t"):
            cfg["t"] = int(a[2:])
        elif a == "-p":
            cfg["p"] = True
        elif a.startswith("-p:"):
            cfg["p"] = True
            cfg["ptable"] = a[3:]
        elif a == "-c":
            cfg["c"] = True
        elif a.startswith("-bc"):
            cfg["bc"] = int(a[3:])
        elif a == "-v":
            cfg["v"] = True
        elif a.startswith("-N"):
            cfg["N"] = a[2:]
        elif a.startswith("-P"):
            cfg["P"] = a[2:]
        elif a.startswith("-M"):
            cfg["M"] = int(a[2:])
        elif a.startswith("-T"):
            cfg["T"] = int(a[2:])
        elif a.startswith("-"):
            die(f"fastk: {a} is an illegal option\n{USAGE}")
        else:
            cfg["inputs"].append(a)
    if not cfg["inputs"]:
        die(USAGE)
    if cfg["k"] < 5:
        die("fastk: k must be at least 5")
    if cfg["k"] > 256:
        # the reference breaks for k ≳ 128 (README.md:239); the W=ceil(k/16)
        # word pipeline here is brute-force-validated through k=256
        # (tests/test_k_range.py), gated there pending larger-k validation
        die("fastk: k must be at most 256")
    return cfg


def main(argv=None):
    cfg = parse_argv(sys.argv[1:] if argv is None else argv)
    import os

    for p in cfg["inputs"]:
        if not os.path.exists(p):
            die(f"fastk: cannot open {p}")
    out_base = (cfg["N"] or source_root(cfg["inputs"][0]))
    return _run(cfg, out_base)


def _clean_outputs(out_base: str) -> None:
    """Remove partial output file-sets on failure (the Clean_Exit analog,
    reference FastK.c:181-221)."""
    from fastk_tpu.tools.fastrm import remove_set

    for ext in (".hist", ".ktab", ".prof"):
        try:
            remove_set(out_base + ext, force=True)
        except Exception:
            pass


def _ooc_plan(est_bases: int, M: float, profiles: bool) -> tuple:
    """(parts, part_cap) for the out-of-core decision — parts == 1 means
    in-core. Both ceilings use measured footprints, worst case one record
    per base (dedup only shrinks it):

    - IN-CORE eligibility: the in-core path retains per-position state for
      the whole run — unique blocks + final merge transients (~56
      B/position worst case; ~80 with the profile instance join) — so it
      requires est * mode_bytes to fit BOTH the device budget (measured:
      jaxenv.device_memory_budget) and the user's -M (the reference's
      SORT_MEMORY semantics, FastK.c:422-429).

    - Otherwise out-of-core: a part's merge costs ~96 B/record in
      sort/segment transients (measured: a 47M-record part merge drives
      ~4.5 GB, benchmarks/bench_rss.py investigation), so part_cap =
      M/96B records and parts = ceil(worst-case records / part_cap) —
      peak memory then stays ~flat past the plateau however large the
      input grows, which is the reference's defining -M property
      (README.md:44-46).
    """
    from fastk_tpu.jaxenv import device_memory_budget

    part_cap = min(1 << 26, max(1 << 22, int(M * 1e9) // 96))
    mode_bytes = 80 if profiles else 56
    if est_bases * mode_bytes <= min(device_memory_budget(), M * 1e9):
        return 1, part_cap
    return max(2, math.ceil(est_bases / part_cap)), part_cap


def _measure_dedup(inputs, k, batch_bases, hc, bc) -> float | None:
    """First-batch device dedup ratio (uniques / valid instances) — the
    reference's Get_First_Block `ratio` estimate (FastK.c:417-429) run on
    the device. One bounded batch: parse, upload, unique_batch. None when
    the measurement fails (caller keeps the conservative plan)."""
    try:
        from fastk_tpu.io.reader import batched_reads
        from fastk_tpu.ops.count import unique_batch
        from fastk_tpu.pipeline.count import _code_slices, _device_codes

        gen = batched_reads(list(inputs), min(batch_bases, 64 << 20),
                            hc=hc, bc=bc)
        first = next(iter(gen), None)
        if first is None:
            return None
        batch = first[0]
        off, size, buf = next(_code_slices(batch.codes, k))
        res = unique_batch(_device_codes(buf), k, size)
        nval = int(res["nvalid"])
        if nval <= 0:
            return None
        return int(res["nuniq"]) / nval
    except Exception:
        return None


def _run(cfg, out_base):
    from fastk_tpu.formats.hist import write_histogram
    from fastk_tpu.formats.ktab import read_ktab, write_ktab
    from fastk_tpu.formats.prof import write_prof
    from fastk_tpu.pipeline.count import count_files

    # device tracing (the -v timers' deep counterpart): set
    # FASTK_TPU_TRACE=<dir> to capture a JAX profiler trace of the run,
    # viewable in Perfetto/TensorBoard
    trace_dir = os.environ.get("FASTK_TPU_TRACE")
    if trace_dir:
        import jax

        jax.profiler.start_trace(trace_dir)

    timer = _Timer()

    rel = None
    if cfg["ptable"]:
        rel = read_ktab(cfg["ptable"])
        if rel.kmer != cfg["k"]:
            # same hard error as the reference (FastK.c:328-333) — callers
            # must pass -k matching the table, as the reference's KmerMap
            # does when it builds its FastK command line
            die(f"fastk: -p table k-mer size ({rel.kmer}) != k-mer "
                f"specified ({cfg['k']})")
        if cfg["t"] is not None:
            # relative profiles supersede -t (FastK.c:334-336)
            if cfg["v"]:
                print(f"fastk: Warning: -p:{cfg['ptable']} overides -t "
                      "option", file=sys.stderr)
            cfg["t"] = None

    # memory budget -> batch size (bases); the device path needs ~24B/base.
    # FASTK_TPU_BATCH_BASES caps it explicitly (tuning/benchmarks: smaller
    # batches trade throughput for a lower device/host footprint)
    batch_bases = min(256 << 20, int(cfg["M"] * 1e9 / 24))
    env_cap = os.environ.get("FASTK_TPU_BATCH_BASES")
    if env_cap:
        batch_bases = min(batch_bases, max(1 << 20, int(env_cap)))

    def _gz_density(f: str) -> float | None:
        """Measured expansion of a gzip member from its first few MB (the
        reference's Get_First_Block `ratio` trick, io.c:2606-2630 /
        FastK.c:417-429, applied to the container instead of the whole
        block): decompressed_bytes / compressed_bytes_consumed."""
        import gzip

        try:
            with open(f, "rb") as raw:
                with gzip.GzipFile(fileobj=raw) as g:
                    data = g.read(4 << 20)
                used = raw.tell()
            if not data or used <= 0:
                return None
            return len(data) / used
        except OSError:
            return None

    heuristic = []

    def _est_base_bytes(f: str) -> int:
        """Estimated BASE count of an input: on-disk size corrected for
        the container. gz expansion is MEASURED from the file's head
        (sequence is roughly half the text for FASTQ, most of it for
        FASTA); Dazzler stubs point at a hidden 2-bit .bps holding 4
        bases/byte; BAM/CRAM keep a x6 heuristic (a high-coverage CRAM
        can beat it badly — the plan's consolidation/sub-split machinery
        absorbs the error, and the verbose line flags the guess)."""
        if not os.path.exists(f):
            return 0
        sz = os.path.getsize(f)
        low = f.lower()
        if low.endswith((".db", ".dam")):
            from fastk_tpu.io.dazz import _hidden

            bps = _hidden(f, ".bps")
            if os.path.exists(bps):
                return os.path.getsize(bps) * 4
            return sz
        if low.endswith(".gz"):
            dens = _gz_density(f)
            if dens is None:
                heuristic.append(os.path.basename(f))
                return sz * 4
            seq_frac = 0.5 if ".fastq" in low or ".fq" in low else 0.9
            return int(sz * dens * seq_frac)
        if low.endswith((".bam", ".cram")):
            heuristic.append(os.path.basename(f))
            return sz * 6
        return sz

    est_bases = sum(_est_base_bytes(f) for f in cfg["inputs"])
    if cfg["v"] and heuristic:
        print("  base estimate for "
              + ", ".join(heuristic[:4])
              + (" ..." if len(heuristic) > 4 else "")
              + " is a container heuristic (x6); the measured first-batch"
              " plan and part sub-splitting absorb the error",
              file=sys.stderr)
    parts, part_cap = _ooc_plan(est_bases, cfg["M"], profiles=cfg["p"])

    nparts = max(1, cfg["T"])

    # multi-host mode: launched with FASTK_TPU_COORD/_NPROCS/_PROC set on
    # every host (the reference's multi-node job plans, README.md:245-353,
    # as ONE lockstep mesh program). Each host streams its keyspace slice;
    # host 0 splices them into the final file-sets with the fastcat
    # machinery and writes the histogram.
    from fastk_tpu.parallel.multihost import init_from_env

    pid, nprocs = init_from_env()
    if nprocs > 1:
        try:
            return _run_mesh(cfg, out_base, rel, batch_bases, nparts,
                             part_cap, est_bases, pid, nprocs)
        except BaseException:
            _clean_outputs(out_base if pid == 0
                           else f"{out_base}.{pid}")
            raise

    try:
        measured_incore = False
        if parts > 1 and rel is None and not cfg["R"]:
            # the static plan assumed worst-case dedup (every position
            # unique); MEASURE the first batch's device dedup ratio and
            # keep the in-core path when the measured footprint fits —
            # at 30-50X coverage this in-cores inputs the worst case
            # would spill, skipping the whole spill round-trip (the
            # reference sizes NPARTS from the same first-block ratio,
            # FastK.c:417-429). -R keeps the conservative plan: the
            # resume manifest is keyed to the ooc path.
            ratio = _measure_dedup(cfg["inputs"], cfg["k"], batch_bases,
                                   cfg["c"], cfg["bc"])
            if ratio is not None:
                # measured-footprint envelopes: hist/table retain the
                # unique blocks + final-merge transients (~56B per
                # UNIQUE); profiles additionally keep every position's
                # sorted instance (W key words + position, uint32 each)
                # device-resident and pay the merge and per-slice join
                # transients (~80B/unique). On one H100 a 1 Gbp 50X
                # HiFi -t3 -p run peaked at 40.0 GB where this says
                # 47.9 GB
                if cfg["p"]:
                    from fastk_tpu.ops.kmers import nwords

                    inst = 4 * nwords(cfg["k"]) + 4
                    in_bytes = est_bases * (inst + ratio * 80)
                else:
                    in_bytes = est_bases * ratio * 56
                from fastk_tpu.jaxenv import device_memory_budget

                if in_bytes <= min(device_memory_budget(), cfg["M"] * 1e9):
                    if cfg["v"]:
                        print(f"  measured dedup ratio {ratio:.3f}: "
                              "in-core (footprint "
                              f"{in_bytes / 1e9:.1f}GB fits)",
                              file=sys.stderr)
                    parts = 1
                    measured_incore = True
        if parts > 1 and rel is None:
            from fastk_tpu.pipeline.outofcore import count_files_ooc

            if cfg["v"]:
                print(f"  out-of-core: <= {parts} keyspace parts under "
                      f"{cfg['M']}GB budget (measured plan follows)",
                      file=sys.stderr)
            # parts=None: the plan is sized INSIDE from the first batch's
            # measured dedup ratio x est_bases (the reference's `ratio`
            # extrapolation, FastK.c:417-429) instead of the worst case
            out = count_files_ooc(
                cfg["inputs"], cfg["k"], None,
                est_bases=est_bases,
                sort_path=cfg["P"],
                table_min=cfg["t"],
                profiles=cfg["p"],
                hc=cfg["c"],
                bc=cfg["bc"],
                batch_bases=batch_bases,
                verbose=cfg["v"],
                out_base=out_base,
                out_nparts=nparts,
                part_cap=part_cap,
                resume=cfg["R"],
            )
        else:
            def _in_core():
                return count_files(
                    cfg["inputs"], cfg["k"],
                    table_min=cfg["t"],
                    profiles=cfg["p"],
                    hc=cfg["c"],
                    bc=cfg["bc"],
                    batch_bases=batch_bases,
                    relative_table=rel,
                    verbose=cfg["v"],
                    out_base=out_base,
                    out_nparts=nparts,
                )

            if measured_incore:
                # the measured-footprint promotion can still lose to a
                # pathological tail (dedup collapses mid-run): a device
                # memory exhaustion demotes back to the out-of-core plan
                try:
                    out = _in_core()
                except Exception as e:
                    from fastk_tpu.jaxenv import is_device_oom

                    if not is_device_oom(e):
                        raise
                    # the failed attempt's traceback frames pin its
                    # device buffers; break the cycle and collect so the
                    # out-of-core retry starts with free device memory
                    import gc

                    e.__traceback__ = None
                    gc.collect()
                    if cfg["v"]:
                        print("  in-core attempt exhausted device memory;"
                              " falling back to out-of-core",
                              file=sys.stderr)
                    _clean_outputs(out_base)
                    from fastk_tpu.pipeline.outofcore import count_files_ooc

                    out = count_files_ooc(
                        cfg["inputs"], cfg["k"], None,
                        est_bases=est_bases, sort_path=cfg["P"],
                        table_min=cfg["t"], profiles=cfg["p"],
                        hc=cfg["c"], bc=cfg["bc"],
                        batch_bases=batch_bases, verbose=cfg["v"],
                        out_base=out_base, out_nparts=nparts,
                        part_cap=part_cap)
            else:
                out = _in_core()

        if out.nshort:
            # the reference's short-read warning (split.c:1533-1538)
            print(f"Warning: {print_number(out.nshort)} reads are shorter "
                  f"than the k-mer size ({cfg['k']}) and contribute no "
                  "k-mers", file=sys.stderr)
        if cfg["v"]:
            print(f"  {print_number(out.nreads)} reads, "
                  f"{print_number(out.totlen)} bases", file=sys.stderr)
            timer.phase()

        # .ktab/.prof were streamed to out_base by the pipeline; only the
        # (small) histogram remains to be written here
        if rel is None:
            write_histogram(out_base, out.hist)
            if cfg["t"] is not None and cfg["v"]:
                print(f"  There are {print_number(out.table_entries)} "
                      f"{cfg['k']}-mers that occur {cfg['t']}-or-more "
                      "times", file=sys.stderr)
    except BaseException:
        # drop partial output file-sets (Clean_Exit, FastK.c:181-221)
        _clean_outputs(out_base)
        raise

    if cfg["v"]:
        timer.phase()
        timer.total()
    if trace_dir:
        import jax

        jax.profiler.stop_trace()
    return 0


def _run_mesh(cfg, out_base, rel, batch_bases, nparts, part_cap, est_bases,
              pid, nprocs):
    """Multi-host job body: every host runs the same lockstep mesh program
    over its file shard and streams `<out>.<pid>` slice file-sets; host 0
    splices them (fastcat) into `<out>` and writes the histogram."""
    from jax.experimental import multihost_utils

    from fastk_tpu.formats.hist import write_histogram
    from fastk_tpu.parallel.meshooc import count_files_mesh, default_mesh

    mesh = default_mesh()
    if cfg["v"] and pid == 0:
        print(f"  multi-host: {nprocs} processes, "
              f"{mesh.devices.size} chips", file=sys.stderr)
    if rel is not None:
        from fastk_tpu.parallel.host import relative_profiles_sharded

        out = relative_profiles_sharded(
            cfg["inputs"], rel, mesh, batch_bases=batch_bases,
            verbose=cfg["v"], out_base=out_base, out_nparts=nparts)
    else:
        # per-chip keyspace parts sized so no phase-2 merge load exceeds
        # the -M-derived part_cap even at worst-case (1 record/base) spill
        D = mesh.devices.size
        ppc = max(1, min(256, -(-est_bases // (D * part_cap))))
        out = count_files_mesh(
            cfg["inputs"], cfg["k"], mesh=mesh, table_min=cfg["t"],
            profiles=cfg["p"], batch_bases=batch_bases,
            sort_path=cfg["P"], out_base=out_base, out_nparts=nparts,
            part_cap=part_cap, parts_per_chip=ppc, hc=cfg["c"],
            bc=cfg["bc"], verbose=cfg["v"], resume=cfg["R"])
    multihost_utils.sync_global_devices("fastk_mesh_slices_done")
    if pid == 0:
        from fastk_tpu.tools.fastcat import (
            cat_profiles_spliced,
            cat_tables_spliced,
            cat_tables_streamed,
        )
        from fastk_tpu.tools.fastrm import remove_set

        slices = [f"{out_base}.{q}" for q in range(nprocs)]
        if rel is None:
            write_histogram(out_base, out.hist)
            if cfg["t"] is not None:
                # destructive splice: O(1) hardlink of slice parts
                if not cat_tables_spliced(slices, out_base, keep=False):
                    cat_tables_streamed(slices, out_base, nparts)
        if cfg["p"]:
            cat_profiles_spliced(slices, out_base, keep=False)
        for s in slices:
            for ext in (".ktab", ".prof"):
                try:
                    remove_set(s + ext, force=True)
                except Exception:
                    pass
        if cfg["v"]:
            print(f"  spliced {nprocs} host slices into {out_base}",
                  file=sys.stderr)
    # hosts leave together so slice files outlive every reader
    multihost_utils.sync_global_devices("fastk_mesh_spliced")
    return 0


class _Timer:
    """The timeTo analog (FastK.c:104-175): per-phase user/sys/wall deltas
    and %utilization in the reference's format ("M:SS.mmm" past a minute,
    else "S.mmm", tagged u/s/w), plus a Total line with peak RSS in MB."""

    def __init__(self):
        self._mark = self._now()
        self._init = self._mark

    @staticmethod
    def _now():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return (ru.ru_utime, ru.ru_stime, time.time(), ru.ru_maxrss)

    @staticmethod
    def _fmt(secs: float, tag: str) -> str:
        ms = int(round(secs * 1000))
        if secs >= 60:
            return f"{ms // 60000}:{(ms // 1000) % 60:02d}.{ms % 1000:03d}{tag}"
        return f"{ms // 1000}.{ms % 1000:03d}{tag}"

    def _line(self, label: str, base) -> tuple:
        now = self._now()
        u, s, w = (now[i] - base[i] for i in range(3))
        txt = (f"{label}  {self._fmt(u, 'u')}  {self._fmt(s, 's')}"
               f"  {self._fmt(w, 'w')}  {100 * (u + s) / max(w, 1e-9):.1f}%")
        return txt, now

    def phase(self) -> None:
        txt, now = self._line("\n  Resources for phase:", self._mark)
        print(txt, file=sys.stderr)
        self._mark = now

    def total(self) -> None:
        txt, now = self._line("\nTotal Resources:", self._init)
        # linux ru_maxrss is KB (the reference's /1000000 assumes bytes)
        print(f"{txt}  {print_number(now[3] // 1000)}MB", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
