"""Out-of-core counting: datasets whose unique k-mer set exceeds device
memory.

The reference bounds memory by routing super-mers to NPARTS disk buckets
sized so one bucket's k-mer array fits in -M GB (FastK.c:422-429,
split.c:1407-1713), then counts bucket-by-bucket. This version:

1. The canonical keyspace is RANGE-partitioned into `parts` intervals of
   word0, with edges trained on the first batch's prefix histogram (the
   trainer analog of Determine_Scheme, split.c:491-803).
2. Each input batch is deduplicated ON DEVICE first (unique_batch), so what
   spills to disk is per-batch (k-mer, count) records — at coverage C this
   is ~C-fold less IO than the reference's super-mer streams.
3. Spill files hold fixed-width (W*uint32 key, uint32 count) records,
   appended per (part); each part's records stay sorted per batch segment.
4. Per part: load spill, device merge (merge_unique_blocks), accumulate the
   histogram, emit the part's table slice. Parts are keyspace-ordered, so
   concatenating their tables yields the final sorted table (the phase-3
   merge of table.c:346-533 is free by construction); with ``out_base`` the
   slices stream straight into the .ktab part files (KtabWriter).
5. Profiles (optional): phase 1's key sort also carries positions
   (unique_batch_inst), and instances spill as (segment-index, position)
   pairs — 8 bytes each, no key bytes: an instance references its
   slice's spilled unique record by index (the analog of the
   reference carrying super-mer ordinals into the bucket files,
   split.c:1167-1277, with the ordinal pointing at the DEDUPED record).
   Phase 2 resolves every instance's count straight from the cross-batch
   merge (merge_unique_blocks want_back returns each input record's
   merged count), so there is no table join and no instance-key
   re-upload; the (position, count) pairs spill per BATCH and phase 3
   walks batches in order, rebuilding one batch's position->count buffer
   at a time and streaming encoded profiles out (ProfWriter) — the
   analog of the reference's bounded-window fragment merge
   (merge.c:88-759) with the window = one batch.

Host memory therefore stays bounded by one batch + one part regardless of
input size: no ReadBatch outlives its phase-1 device call, and no output
is buffered whole (the reference's defining claim, README.md:44-46).
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax.numpy as jnp

import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)
from fastk_tpu.formats.hist import HIST_HIGH, Histogram
from fastk_tpu.formats.ktab import KmerTable, KtabWriter
from fastk_tpu.formats.prof import ProfWriter, encode_profiles_bulk
from fastk_tpu.io.reader import batched_reads
from fastk_tpu.ops.count import (
    merge_unique_blocks,
    unique_batch,
    unique_batch_inst,
)
from fastk_tpu.ops.kmers import nwords, words_to_packed

from fastk_tpu.pipeline.count import (
    CountOutput,
    _device_codes,
    _code_slices,
    _profiles_from_meta,
)


def _train_edges(words0: np.ndarray, parts: int) -> np.ndarray:
    """Upper-bound edges (exclusive) on word0 for each part but the last,
    chosen at quantiles of the first batch's uniques."""
    if parts <= 1:
        return np.zeros(0, dtype=np.uint32)
    if len(words0) == 0:
        return ((np.arange(1, parts) * (1 << 32)) // parts).astype(np.uint32)
    qs = [words0[min(len(words0) - 1, len(words0) * t // parts)]
          for t in range(1, parts)]
    return np.array(qs, dtype=np.uint32)


@dataclass
class _BatchMeta:
    """Per-batch read layout retained after the codes are dropped: a few
    bytes per READ (vs 1 byte per BASE for the codes themselves)."""

    boff: np.ndarray  # int64 [nreads+1] code offsets
    rlen: np.ndarray  # int64 [nreads]
    codes_len: int

    @property
    def nreads(self) -> int:
        return len(self.rlen)

    @property
    def totlen(self) -> int:
        return int(self.rlen.sum())


class _Spill:
    """Per-part append-only spill of (W words, count) uint32 records.

    resume_nrec: per-part record counts from a prior run's manifest; files
    are truncated to exactly those counts (dropping any partially-written
    batch) and opened for append."""

    def __init__(self, dirpath: str, parts: int, W: int,
                 resume_nrec: Optional[List[int]] = None):
        os.makedirs(dirpath, exist_ok=True)
        self.W = W
        self.paths = [os.path.join(dirpath, f"part{p}.spill")
                      for p in range(parts)]
        if resume_nrec is not None:
            rb = 4 * (W + 1)
            for p, nr in zip(self.paths, resume_nrec):
                with open(p, "ab") as f:
                    pass  # ensure exists
                os.truncate(p, nr * rb)
            self.files = [open(p, "ab") for p in self.paths]
            self.nrec = list(resume_nrec)
            return
        self.files = [open(p, "wb") for p in self.paths]
        self.nrec = [0] * parts

    def append(self, p: int, words: np.ndarray, counts: np.ndarray) -> None:
        n = len(counts)
        if n == 0:
            return
        rec = np.empty((n, self.W + 1), dtype=np.uint32)
        rec[:, : self.W] = words
        rec[:, self.W] = counts
        rec.tofile(self.files[p])
        self.nrec[p] += n

    def flush(self) -> None:
        """Push buffered records to the OS — called before each manifest
        save so a SIGKILL can never persist a manifest that claims more
        records than the spill files hold."""
        for f in self.files:
            f.flush()

    def truncate(self, nrec: List[int]) -> None:
        """Roll every part back to an exact record count (a failed mesh
        round re-runs after truncating its partial spills)."""
        rb = 4 * (self.W + 1)
        for p, nr in enumerate(nrec):
            self.files[p].flush()
            os.truncate(self.paths[p], nr * rb)
            self.files[p].seek(nr * rb)
            self.nrec[p] = nr

    def load(self, p: int) -> Tuple[np.ndarray, np.ndarray]:
        self.files[p].flush()
        rec = np.fromfile(self.paths[p], dtype=np.uint32
                          ).reshape(self.nrec[p], self.W + 1)
        return rec[:, : self.W], rec[:, self.W]

    def close(self, remove: bool = True) -> None:
        for f in self.files:
            f.close()
        if remove:
            for p in self.paths:
                try:
                    os.unlink(p)
                except OSError:
                    pass


class _PosSpill:
    """Per-BATCH append-only spill of (position, count) pairs — the joined
    profile values on their way back to read order. 6 bytes/instance as
    3 little-endian uint16 (positions are batch-local)."""

    def __init__(self, dirpath: str):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self.nrec: dict[int, int] = {}

    def _path(self, b: int) -> str:
        return os.path.join(self.dir, f"batch{b}.pos")

    def append(self, b: int, pos: np.ndarray, cnt: np.ndarray) -> None:
        n = len(pos)
        if n == 0:
            return
        rec = np.empty((n, 3), dtype="<u2")
        rec[:, :2] = pos.astype("<u4").view("<u2").reshape(n, 2)
        rec[:, 2] = cnt.astype("<u2")
        with open(self._path(b), "ab") as f:
            rec.tofile(f)
        self.nrec[b] = self.nrec.get(b, 0) + n

    def load(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        n = self.nrec.get(b, 0)
        if n == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.uint16)
        rec = np.fromfile(self._path(b), dtype="<u2").reshape(n, 3)
        pos = np.ascontiguousarray(rec[:, :2]).view("<u4").ravel()
        return pos.astype(np.int64), rec[:, 2].astype(np.uint16)

    def close(self) -> None:
        for b in self.nrec:
            try:
                os.unlink(self._path(b))
            except OSError:
                pass


def _run_signature(paths, k, parts, table_min, profiles, hc, bc,
                   batch_bases) -> str:
    """Deterministic identity of an ooc run: same inputs (path/size/mtime)
    and same configuration — the key that makes a crashed run resumable."""
    ident = []
    for p in paths:
        st = os.stat(p)
        ident.append((os.path.abspath(p), st.st_size, int(st.st_mtime)))
    blob = repr((ident, k, parts, table_min, profiles, hc, bc, batch_bases))
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _manifest_path(base: str) -> str:
    return os.path.join(base, "manifest.json")


def _save_manifest(base: str, state: dict) -> None:
    tmp = _manifest_path(base) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, _manifest_path(base))  # atomic: torn writes can't win


def _load_manifest(base: str) -> Optional[dict]:
    try:
        with open(_manifest_path(base)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def count_files_ooc(
    paths: Sequence[str],
    k: int,
    parts: Optional[int],
    sort_path: str = "/tmp",
    table_min: Optional[int] = None,
    profiles: bool = False,
    hc: bool = False,
    bc: int = 0,
    batch_bases: int = 64 << 20,
    verbose: bool = False,
    out_base: Optional[str] = None,
    out_nparts: int = 4,
    part_cap: int = 1 << 26,
    resume: bool = False,
    est_bases: Optional[int] = None,
) -> CountOutput:
    """Bounded-memory counting via `parts` disk buckets (the -M path).

    With ``out_base`` the .ktab (if table_min) and .prof (if profiles)
    file-sets are STREAMED to disk as they are produced; the returned
    CountOutput then has table=None/profiles=None and table_entries set.

    parts=None sizes the plan from MEASURED data: the first batch's device
    dedup ratio (uniques/valid — the reference's `ratio` extrapolation,
    FastK.c:417-429) times est_bases estimates the total spilled records,
    and parts = ceil(est / part_cap). At coverage C this plans ~C-fold
    fewer parts than the worst case. Whatever the plan, phase 2
    CONSOLIDATES consecutive near-empty parts into one device merge (so
    over-provisioning costs file handles, not device calls) and sub-splits
    overflowing ones.

    part_cap: max records merged in one device call; a part whose spill
    exceeds it is sub-split at word0 quantiles (skew recovery).

    resume: on failure KEEP the phase-1 spill + a batch-granular manifest;
    a rerun with the same inputs/config re-enters phase 1 after the last
    completed batch (the reference's DEVELOPER staged restart,
    FastK.c:302-315, at batch instead of phase granularity). Device work
    already spilled is never redone.
    """
    W = nwords(k)
    sig = _run_signature(paths, k, "auto" if parts is None else parts,
                         table_min, profiles, hc, bc, batch_bases)
    base = os.path.join(sort_path, f"fastk_tpu_ooc.{sig}")
    state = _load_manifest(base) if resume else None
    if state is not None and (state.get("sig") != sig
                              or state.get("fmt") != 2):
        # fmt 2: instance spill is (seg_rel, pos) with (bidx, n, uoff)
        # imeta triples; older manifests are not resumable
        state = None
    if state is not None and parts is None:
        parts = state.get("parts")  # resolved by the interrupted run
    # phase-2 .pos state is never resumable: clear it even when resuming,
    # or stale batch*.pos from a hard-killed phase 2 would be appended to
    if os.path.isdir(base + ".pos"):
        shutil.rmtree(base + ".pos", ignore_errors=True)
    if state is None:
        for d in (base, base + ".inst"):
            if os.path.isdir(d):  # stale leftovers of a crashed run
                shutil.rmtree(d, ignore_errors=True)
    bdone = state["batches_done"] if state else 0
    if verbose and bdone:
        print(f"  resume: phase 1 re-enters after batch {bdone}",
              flush=True)
    # with parts=None the spills are created on the first batch, once the
    # measured ratio fixes the plan
    spill: Optional[_Spill] = None
    ispill: Optional[_Spill] = None
    imeta: List[List[Tuple[int, int]]] = []
    if parts is not None:
        spill = _Spill(base, parts, W,
                       resume_nrec=state["nrec"] if state else None)
        # instance spill: value column = batch-local position; per-part
        # append metadata (batch idx, n) rebuilds the batch column on load
        ispill = (_Spill(base + ".inst", parts, 1,
                         resume_nrec=state["inrec"] if state else None)
                  if profiles else None)
        imeta = ([[tuple(x) for x in lst] for lst in state["imeta"]]
                 if state else [[] for _ in range(parts)])
    pspill = _PosSpill(base + ".pos") if profiles else None
    edges: Optional[np.ndarray] = (
        np.array(state["edges"], dtype=np.uint32) if state else None)
    metas: List[_BatchMeta] = []
    nvalid_total = state["nvalid"] if state else 0
    stream = out_base is not None
    keep_spill = False

    try:
        # ---- phase 1: per-batch device dedup, spill by key range ----------
        def _spill_one(res, label, batch_complete: bool):
            nonlocal nvalid_total, edges, parts, spill, ispill, imeta
            bidx, nreads, off = label
            nu = int(res["nuniq"])
            nval = int(res["nvalid"])
            nvalid_total += nval
            words = np.stack(
                [np.asarray(w[:nu]) for w in res["seg_words"]], axis=1)
            counts = np.asarray(res["seg_counts"][:nu]).astype(np.uint32)
            if parts is None:
                # measured-coverage plan: extrapolate total spilled records
                # as est_bases x (first-slice uniques / valid instances),
                # with 25% headroom for cross-batch novelty; sub-split and
                # consolidation absorb estimation error in either direction
                ratio = nu / max(nval, 1)
                est = max(est_bases or 0, nval)
                want = math.ceil(est * ratio * 1.25 / part_cap)
                if profiles:
                    # the INSTANCE spill is one record per valid position
                    # (not deduped): a part's phase-2 join pads to the
                    # pow2 of its instance count, so parts must bound
                    # instances per part too
                    want = max(want, math.ceil(est / part_cap))
                parts = max(2, min(4096, want))
                if verbose:
                    print(f"  measured dedup ratio {ratio:.3f}: planning "
                          f"{parts} parts", flush=True)
            if spill is None:
                spill = _Spill(base, parts, W)
                if profiles:
                    ispill = _Spill(base + ".inst", parts, 1)
                imeta = [[] for _ in range(parts)]
            if edges is None:
                edges = _train_edges(words[:, 0] if nu else
                                     np.zeros(0, np.uint32), parts)
            cuts = ([0] + [int(np.searchsorted(words[:, 0], e))
                           for e in edges] + [nu])
            upre = list(spill.nrec)  # per-part unique offsets pre-append
            for p in range(parts):
                spill.append(p, words[cuts[p]: cuts[p + 1]],
                             counts[cuts[p]: cuts[p + 1]])
            if profiles:
                # valid instances lead the sorted stream (invalid fold to
                # all-ones keys and sort last); + off makes positions
                # batch-local across device slices. Instances spill as
                # (seg_rel, pos) — 8B each, no key bytes: seg_rel indexes
                # this chunk's unique records within its part (offset
                # upre[p], recorded in imeta), and phase 2 resolves
                # counts straight from the merge (want_back), so no
                # table join or query upload happens at all
                # seg of instance i, derived for free: the instance
                # stream is the segments concatenated in key order, so
                # repeat(arange(nu), counts) IS the per-instance segment
                # index (no device fetch — only s_pos crosses the link)
                s_seg = np.repeat(np.arange(nu, dtype=np.int64),
                                  counts.astype(np.int64))
                ipos = np.asarray(res["s_pos"][:nval]) + np.uint32(off)
                icuts = ([0] + [int(np.searchsorted(s_seg, c))
                                for c in cuts[1:-1]] + [nval])
                for p in range(parts):
                    lo, hi = icuts[p], icuts[p + 1]
                    if hi > lo:
                        ispill.append(
                            p,
                            (s_seg[lo:hi] - cuts[p]).astype(
                                np.uint32)[:, None],
                            ipos[lo:hi])
                        imeta[p].append((bidx, hi - lo, upre[p]))
            if verbose:
                print(f"  batch {bidx + 1}: {nreads} reads, "
                      f"{nu} uniques spilled", flush=True)
            if resume and batch_complete:
                # only a FULLY spilled batch may enter the manifest (large
                # batches run in several device slices sharing one bidx),
                # and only after its records are flushed past userspace
                spill.flush()
                if ispill is not None:
                    ispill.flush()
                _save_manifest(base, dict(
                    sig=sig, fmt=2, batches_done=bidx + 1, nrec=spill.nrec,
                    inrec=ispill.nrec if ispill is not None else None,
                    imeta=imeta, nvalid=nvalid_total, parts=parts,
                    edges=[int(x) for x in edges]))

        # one-batch lookahead so the next batch's parse/pack/H2D overlaps
        # the previous batch's device compute (mirrors pipeline.count)
        pending = None
        for batch, _ord in batched_reads(list(paths), batch_bases,
                                         hc=hc, bc=bc):
            metas.append(_BatchMeta(np.asarray(batch.boff),
                                    np.asarray(batch.rlen),
                                    len(batch.codes)))
            if len(metas) - 1 < bdone:
                del batch  # already spilled by the interrupted run
                continue
            for off, size, buf in _code_slices(batch.codes, k):
                dc = _device_codes(buf)
                res = (unique_batch_inst(dc, k, size) if profiles
                       else unique_batch(dc, k, size))
                label = (len(metas) - 1, metas[-1].nreads, off)
                if pending is not None:
                    # the deferred slice completed its batch iff the slice
                    # now dispatched belongs to a LATER batch
                    _spill_one(*pending,
                               batch_complete=pending[1][0] != label[0])
                pending = (res, label)
            del batch  # codes must not outlive phase 1 (bounded RSS)
        if pending is not None:
            _spill_one(*pending, batch_complete=True)
        if spill is None:  # empty input: no batch ever resolved the plan
            parts = parts or 2
            spill = _Spill(base, parts, W)
            if profiles:
                ispill = _Spill(base + ".inst", parts, W)
            imeta = [[] for _ in range(parts)]

        nreads = sum(m.nreads for m in metas)
        totlen = sum(m.totlen for m in metas)

        if verbose and sum(spill.nrec):
            # per-part balance report (the reference's distribution-plan
            # diagnostic, split.c:1582-1655): bucket skew is THE signal
            # that part sizing / edge training needs attention
            tot = sum(spill.nrec)
            avg = tot / parts
            print("  part balance: " + " ".join(
                f"{100.0 * n / tot:.1f}%" for n in spill.nrec), flush=True)
            print(f"  part skew: max {max(spill.nrec) / avg:.2f}x avg, "
                  f"min {min(spill.nrec) / avg:.2f}x avg", flush=True)

        # ---- phase 2: per-part device merge -------------------------------
        hist_arr = np.zeros(HIST_HIGH + 1, dtype=np.int64)
        packed_parts: List[np.ndarray] = []
        count_parts: List[np.ndarray] = []
        ktw = None
        table_entries = 0
        if stream and table_min is not None:
            # cap the writer's RAM spool alongside the part budget so the
            # whole -M path's host peak scales with -M, not the table size
            ktw = KtabWriter(out_base, k, table_min, nparts=out_nparts,
                             spill_bytes=min(
                                 int(os.environ.get(
                                     "FASTK_TPU_KTAB_SPILL_MB", "1024"))
                                 << 20,
                                 16 * part_cap))

        def _merge_range(words, counts, rows, ipos, bcol):
            nonlocal table_entries
            from fastk_tpu.ops.tables import pad_counted_pow2

            nq = len(ipos) if profiles and ipos is not None else 0
            m_words, m_counts, cap = pad_counted_pow2(words, counts, W)
            merged = merge_unique_blocks(m_words, m_counts, cap, k,
                                         want_back=nq > 0)
            hist_arr[:] += np.asarray(merged["hist"]).astype(np.int64)

            nuniq = int(merged["nuniq"])
            if table_min is not None:
                if table_min > 1:
                    # device-side threshold compaction: only the kept
                    # entries cross the device->host link (ops.count
                    # .compact_table_min; at -t3 the sub-threshold error
                    # tail is most of the uniques)
                    from fastk_tpu.ops.count import compact_table_min

                    kept = compact_table_min(
                        merged["seg_words"], merged["seg_counts"],
                        table_min)
                    nkeep = int(kept["nkeep"])
                    u_words = np.stack(
                        [np.asarray(w[:nkeep]) for w in kept["words"]],
                        axis=1)
                    u_counts = np.asarray(
                        kept["counts"][:nkeep]).astype(np.uint16)
                    keep = slice(None)
                    table_entries += nkeep
                else:
                    u_words = np.stack(
                        [np.asarray(w[:nuniq])
                         for w in merged["seg_words"]], axis=1)
                    u_counts = np.minimum(
                        np.asarray(merged["seg_counts"][:nuniq]), HIST_HIGH
                    ).astype(np.uint16)
                    keep = u_counts >= table_min
                    table_entries += int(keep.sum())
                if ktw is not None:
                    ktw.add(words_to_packed(u_words[keep], k),
                            u_counts[keep])
                else:
                    packed_parts.append(words_to_packed(u_words[keep], k))
                    count_parts.append(u_counts[keep])
                del u_words, u_counts
            if profiles and nq:
                from fastk_tpu.ops.pack import fetch_u16

                # instance counts come straight from the merge: rows
                # index the group's spilled unique records, whose merged
                # (clipped) counts rec_counts returns in input order —
                # no table join, no query upload (the former
                # profile_join_keys pass re-sorted table+queries and
                # re-uploaded every instance key)
                cvec = fetch_u16(
                    merged["rec_counts"].astype(jnp.uint16))[: len(counts)]
                cnts = cvec[rows]
                # route joined values back to their batches (pos order
                # restored in phase 3, one batch at a time)
                for b in np.unique(bcol):
                    m = bcol == b
                    pspill.append(int(b), ipos[m], cnts[m])

        # consolidate consecutive near-empty parts into one device merge:
        # parts are keyspace-ordered, so a group is just a wider range and
        # its merged output still concatenates in order (the inverse of
        # sub-splitting; heals over-provisioned plans). Profile jobs bound
        # BOTH loads: the unique merge and the instance join each pad to
        # their own pow2.
        def _load_of(ps):
            u = sum(spill.nrec[q] for q in ps)
            i_ = (sum(ispill.nrec[q] for q in ps) if profiles else 0)
            return max(u, i_)

        groups: List[List[int]] = []
        for p in range(parts):
            if groups and _load_of(groups[-1] + [p]) <= part_cap:
                groups[-1].append(p)
            else:
                groups.append([p])
        if verbose and len(groups) < parts:
            print(f"  {parts} parts consolidated into {len(groups)} "
                  "merges", flush=True)

        for grp in groups:
            loads = [spill.load(p) for p in grp]
            words = np.concatenate([w for w, _ in loads])
            counts = np.concatenate([c for _, c in loads])
            del loads
            if profiles:
                # absolute unique-row index of each instance within the
                # group's concatenated spill arrays: part base + chunk's
                # unique offset (imeta) + the spilled seg_rel
                pbase = np.cumsum([0] + [spill.nrec[q] for q in grp[:-1]])
                rows_parts = []
                for j, q in enumerate(grp):
                    srel, ip = ispill.load(q)
                    uoffs = np.repeat(
                        np.array([u for _, _, u in imeta[q]], np.int64),
                        [n_ for _, n_, _ in imeta[q]])
                    rows_parts.append(
                        (int(pbase[j]) + uoffs + srel[:, 0], ip))
                rows = np.concatenate([r for r, _ in rows_parts])
                ipos = np.concatenate([p_ for _, p_ in rows_parts])
                del rows_parts
                bcol = np.concatenate([np.repeat(
                    np.array([b for b, _, _ in imeta[p]], np.int64),
                    [cnt_n for _, cnt_n, _ in imeta[p]]) for p in grp])
            else:
                rows = ipos = bcol = None
            n = len(counts)
            load = max(n, len(ipos) if profiles else 0)
            p = grp[0]
            if load <= part_cap:
                if verbose:
                    print(f"  part {p + 1}/{parts}"
                          + (f" (+{len(grp) - 1})" if len(grp) > 1 else "")
                          + f": {n} records", flush=True)
                _merge_range(words, counts, rows, ipos, bcol)
                continue
            # part overflow recovery: sub-split the part at word0 quantile
            # values (identical keys share word0, so sub-ranges still
            # partition the keyspace and concatenate in order) — the
            # adaptive analog of the reference's trie refinement on bucket
            # skew (split.c:437-472), applied at merge time so no spilled
            # record ever moves
            nsub = math.ceil(load / part_cap)
            rng = np.random.default_rng(0)
            sample = words[rng.integers(0, n, min(n, 1 << 20)), 0]
            sample.sort()
            vals = np.unique(np.array(
                [sample[len(sample) * t // nsub] for t in range(1, nsub)],
                dtype=np.uint32))
            if verbose:
                print(f"  part {p + 1}/{parts}: {n} records, sub-split "
                      f"into {len(vals) + 1} ranges", flush=True)
            bounds = [None, *vals.tolist(), None]
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                m = np.ones(n, dtype=bool)
                if lo is not None:
                    m &= words[:, 0] >= lo
                if hi is not None:
                    m &= words[:, 0] < hi
                if profiles:
                    # an instance belongs to the sub-range of ITS unique
                    # record; row indexes remap to the filtered array
                    mi = m[rows]
                    remap = np.cumsum(m) - 1
                    _merge_range(words[m], counts[m], remap[rows[mi]],
                                 ipos[mi], bcol[mi])
                else:
                    _merge_range(words[m], counts[m], None, None, None)
            del words, counts, rows, ipos, bcol

        overflow = nvalid_total - int(
            (hist_arr[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
        hist = Histogram.from_bins(k, hist_arr, overflow)

        table = None
        if table_min is not None:
            if ktw is not None:
                ktw.close()
                ktw = None
            else:
                table = KmerTable(k, table_min, np.concatenate(packed_parts),
                                  np.concatenate(count_parts))
                table_entries = len(table)

        # ---- phase 3: profiles back to read order, one batch at a time ----
        profs = None
        pw = None
        if profiles:
            if stream:
                pw = ProfWriter(out_base, k, nreads,
                                nparts=min(out_nparts, max(1, nreads)))
            else:
                profs = []
            for b, meta in enumerate(metas):
                buf = np.zeros(meta.codes_len, dtype=np.uint16)
                pos, cnt = pspill.load(b)
                buf[pos] = cnt
                if pw is not None:
                    plen = np.maximum(meta.rlen - k + 1, 0)
                    blob, offs = encode_profiles_bulk(
                        buf, meta.boff[:-1], plen)
                    pw.add_block(blob, offs)
                else:
                    profs.extend(_profiles_from_meta(
                        meta.boff, meta.rlen, buf, k))
            if pw is not None:
                pw.close()
                pw = None
        out = CountOutput(k, hist, table, profs, nreads, totlen,
                          nshort=sum(int((m.rlen < k).sum()) for m in metas))
        out.table_entries = table_entries if table_min is not None else None
        return out
    except BaseException:
        # with resume on, the spill + manifest survive for a rerun
        keep_spill = resume
        raise
    finally:
        if spill is not None:
            spill.close(remove=not keep_spill)
        if ispill is not None:
            ispill.close(remove=not keep_spill)
        if pspill is not None:
            pspill.close()  # phase-3 spill is never resumed from
        if not keep_spill:
            try:
                os.unlink(_manifest_path(base))
            except OSError:
                pass
        for d in (base, base + ".inst", base + ".pos"):
            try:
                os.rmdir(d)
            except OSError:
                pass
