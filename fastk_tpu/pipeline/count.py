"""The end-to-end k-mer counting pipeline (single-chip).

Phases (vs the reference's 4-phase disk pipeline, FastK.c:223-561):

1. Host ingest: parse + pack reads into code-stream batches (io.reader).
2. Device count: per batch, canonical keys -> sort -> segment reduction ->
   compacted sorted unique (k-mer, count) blocks, kept DEVICE-RESIDENT
   (ops.count.unique_batch).
3. Device merge: one global sort of the concatenated unique blocks sums
   counts across batches (ops.count.merge_unique_blocks) — the analog of the
   reference's phase-3 table merge (table.c:346-533), as a device sort
   instead of a file heap-merge.
4. Outputs: .hist from the device histogram (exact overflow accounting on
   host: overflow = nvalid - sum(c*hist[c])), .ktab via one final D2H of the
   merged table, .prof via a second device pass per batch that sort-merge
   joins every position's key against the merged table (ops.count
   .profile_join) — the reference's profile inversion by LSD sorts
   (count.c:619-1004) becomes a join + one sort by position.

Everything bulky stays in device memory; the host only sees scalars until
final output encoding. (Host-side merging is also pathologically slow on
first-touch-throttled VMs, which this design sidesteps entirely.)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)

from fastk_tpu.formats.hist import HIST_HIGH, Histogram
from fastk_tpu.formats.ktab import KmerTable
from fastk_tpu.io.reader import ReadBatch, batched_reads
from fastk_tpu.ops.count import (
    merge_unique_blocks,
    profile_join,
    unique_batch,
)
from fastk_tpu.ops.kmers import (
    nwords,
    pad_needed,
    packed_to_words,
    words_to_packed,
)

DEFAULT_BATCH_BASES = 64 << 20  # bases per device batch
_MIN_SIZE = 1 << 15
# hard cap on window positions per device call: reads longer than a batch
# (assembly contigs fed to KmerMap, ultra-long ONT) are processed in
# overlapping slices of this many positions — the reference's block split
# with a (k-1)-base halo (io.c:296-333, FastK.h:95-97) at the device
# boundary. Each k-mer start position belongs to exactly one slice.
MAX_DEVICE_POSITIONS = 1 << 26


def _round_size(n: int, k: int) -> int:
    """Static device shape for a batch: next power of two (min 32k), so the
    number of distinct compilations stays logarithmic in input size."""
    want = n + pad_needed(k)
    size = _MIN_SIZE
    while size < want:
        size <<= 1
    return min(size, MAX_DEVICE_POSITIONS)


def _pad_codes(batch: ReadBatch, k: int, size: int) -> np.ndarray:
    need = size + pad_needed(k)
    codes = np.full(need, 4, dtype=np.uint8)
    codes[: len(batch.codes)] = batch.codes
    return codes


def _code_slices(codes: np.ndarray, k: int):
    """Partition a code stream into (offset, size, padded_slice) windows of
    at most MAX_DEVICE_POSITIONS k-mer start positions each; slice i covers
    starts [offset, offset+size) and carries the k-1 halo after them."""
    n = len(codes)
    size = _round_size(n, k)
    pad = pad_needed(k)
    off = 0
    while off < n or off == 0:
        take = min(size, max(n - off, 0))
        buf = np.full(size + pad, 4, dtype=np.uint8)
        chunk = codes[off: off + take + pad]
        buf[: len(chunk)] = chunk
        yield off, size, buf
        off += size
        if take < size:
            break


def _device_codes(codes_np: np.ndarray):
    """Host codes -> device codes via the 2-bit uint32-word ingress."""
    from fastk_tpu.ops.pack import pack_stream_words

    pw, exc = pack_stream_words(codes_np)
    return _upload_packed(pw, exc, len(codes_np))


def _upload_packed(pw: np.ndarray, exc: np.ndarray, n: int):
    from fastk_tpu.ops.pack import unpack_words

    return unpack_words(jnp.asarray(pw), jnp.asarray(exc), n)


def _packed_slices(codes: np.ndarray, k: int):
    """_code_slices, pre-packed for transfer: yields (off, size, pw, exc).
    The packed form is what the profile second pass retains — 2 bits/base
    instead of the 8-bit code stream."""
    from fastk_tpu.ops.pack import pack_stream_words

    for off, size, buf in _code_slices(codes, k):
        pw, exc = pack_stream_words(buf)
        yield off, size, pw, exc, len(buf)


def _trim(n: int) -> int:
    """Block slot count to keep for n uniques (multiple of 32k)."""
    return max(_MIN_SIZE, ((n + _MIN_SIZE - 1) // _MIN_SIZE) * _MIN_SIZE)


@dataclass
class CountOutput:
    kmer: int
    hist: Optional[Histogram]
    table: Optional[KmerTable]
    profiles: Optional[List[np.ndarray]]
    nreads: int
    totlen: int
    # set when outputs were STREAMED to disk (table/profiles above are then
    # None): number of table entries written, for reporting
    table_entries: Optional[int] = None
    # reads shorter than k (contribute no k-mers; the reference warns,
    # split.c:1533-1538)
    nshort: int = 0


def _profiles_from_meta(boff: np.ndarray, rlen: np.ndarray,
                        pos_counts: np.ndarray, k: int) -> List[np.ndarray]:
    profs = []
    for r in range(len(rlen)):
        o = int(boff[r])
        n = int(rlen[r]) - k + 1
        if n <= 0:
            profs.append(np.zeros(0, dtype=np.uint16))
        else:
            profs.append(pos_counts[o: o + n].astype(np.uint16))
    return profs


def _profiles_from_positions(batch: ReadBatch, pos_counts: np.ndarray, k: int
                             ) -> List[np.ndarray]:
    return _profiles_from_meta(batch.boff, batch.rlen, pos_counts, k)


def _device_table(table: KmerTable, k: int) -> Tuple[tuple, jnp.ndarray]:
    """Host table -> device (words tuple, counts), padded to a 32k multiple
    with all-ones/0 empty slots."""
    W = nwords(k)
    words = packed_to_words(table.packed, k)
    n = words.shape[0]
    cap = _trim(n)
    wpad = np.full((cap, W), 0xFFFFFFFF, dtype=np.uint32)
    wpad[:n] = words
    cpad = np.zeros(cap, dtype=np.int32)
    cpad[:n] = np.minimum(table.counts, HIST_HIGH)
    return (tuple(jnp.asarray(wpad[:, j]) for j in range(W)),
            jnp.asarray(cpad))


class _ProfSink:
    """Where finished per-batch position counts go: a streaming ProfWriter
    (out_base set — bounded memory) or an in-memory list of count arrays."""

    def __init__(self, k: int, out_base: Optional[str], out_nparts: int,
                 nreads: int):
        self.k = k
        self.profs: Optional[List[np.ndarray]] = None
        self._pw = None
        if out_base is not None:
            from fastk_tpu.formats.prof import ProfWriter

            self._pw = ProfWriter(out_base, k, nreads,
                                  nparts=min(out_nparts, max(1, nreads)))
        else:
            self.profs = []

    def add_batch(self, boff: np.ndarray, rlen: np.ndarray,
                  pos_counts: np.ndarray) -> None:
        if self._pw is not None:
            from fastk_tpu.formats.prof import encode_profiles_bulk

            plen = np.maximum(np.asarray(rlen) - self.k + 1, 0)
            blob, offs = encode_profiles_bulk(
                pos_counts.astype(np.uint16, copy=False),
                np.asarray(boff[:-1]), plen)
            self._pw.add_block(blob, offs)
        else:
            self.profs.extend(
                _profiles_from_meta(boff, rlen, pos_counts, self.k))

    def close(self) -> None:
        if self._pw is not None:
            self._pw.close()


def count_files(
    paths: Sequence[str],
    k: int,
    table_min: Optional[int] = None,
    profiles: bool = False,
    hc: bool = False,
    bc: int = 0,
    batch_bases: int = DEFAULT_BATCH_BASES,
    relative_table: Optional[KmerTable] = None,
    verbose: bool = False,
    out_base: Optional[str] = None,
    out_nparts: int = 4,
) -> CountOutput:
    """Count canonical k-mers in the given sequence files.

    relative_table: if given, profiles are taken against this table instead of
    the input's own counts (the -p:<table> mode, reference split.c:1943-2131)
    and no counting pass runs at all.

    out_base: stream the .ktab/.prof file-sets to disk as produced instead of
    returning them in memory (table/profiles come back None, table_entries
    set). Profile jobs then retain only the 2-bit packed code stream between
    passes (0.25 B/base); nothing else outlives its batch.
    """
    W = nwords(k)
    metas: List[Tuple[np.ndarray, np.ndarray, int]] = []  # boff, rlen, clen
    packed_store: List[List[tuple]] = []  # per batch: packed device slices
    blocks_words: List[tuple] = []  # device-resident compacted unique blocks
    blocks_counts: List[jnp.ndarray] = []
    nvalid_total = 0
    retain_packed = profiles  # the profile pass re-reads the code stream
    # fused multi-batch profiles: retain each batch's SORTED instance stream
    # (folded key words + position) device-resident out of the counting sort
    # (ops.count.unique_batch_inst), so the profile pass joins directly with
    # no re-upload and no canonical recompute — the in-core analog of the
    # out-of-core instance spill. The streams may fill half the device
    # budget (the other half holds the unique blocks and the merge and
    # join transients); slices past it re-upload their retained 2-bit
    # packed codes instead.
    from fastk_tpu.jaxenv import device_memory_budget

    inst_budget = device_memory_budget() // 2 if profiles else 0
    inst_store: List[List[tuple]] = []  # per batch: (off, size, s_words, s_pos)
    inst_bytes = 0

    def _finalize(res, size):
        nonlocal nvalid_total
        nu = int(res["nuniq"])
        nvalid_total += int(res["nvalid"])
        keep = min(_trim(nu), size)
        blocks_words.append(tuple(w[:keep] for w in res["seg_words"]))
        blocks_counts.append(res["seg_counts"][:keep])

    # one-batch lookahead: batch i+1's host parse/pack/H2D overlaps batch
    # i's device compute (the scalar fetches in _finalize are the only syncs)
    pending = None
    first_two: List[ReadBatch] = []
    gen = batched_reads(list(paths), batch_bases, hc=hc, bc=bc)
    for batch, _ordinal in gen:
        first_two.append(batch)
        if len(first_two) == 2:
            break

    if (profiles and relative_table is None and len(first_two) == 1
            and len(first_two[0].codes) + pad_needed(k) <= MAX_DEVICE_POSITIONS):
        # single batch with profiles: the fused path — per-position counts
        # come straight out of the counting sort, no second join pass
        return _count_single_fused(first_two[0], k, table_min, verbose,
                                   out_base, out_nparts)

    if (not profiles and table_min is None and relative_table is None
            and len(first_two) == 1
            and len(first_two[0].codes) + pad_needed(k) <= MAX_DEVICE_POSITIONS):
        # single batch, histogram only (the plain `FastK -k` job): the lean
        # hist_batch kernel — no segment compaction, no merge pass
        return _count_single_hist(first_two[0], k, verbose)

    def _batches():
        yield from first_two
        for batch, _ordinal in gen:
            yield batch

    for batch in _batches():
        metas.append((np.asarray(batch.boff), np.asarray(batch.rlen),
                      len(batch.codes)))
        if retain_packed:
            packed_store.append([])
            inst_store.append([])
        for off, size, pw, exc, blen in _packed_slices(batch.codes, k):
            if retain_packed:
                packed_store[-1].append((off, size, pw, exc, blen))
            if relative_table is None:
                rec_bytes = size * (4 * W + 4)
                fuse = (retain_packed
                        and inst_bytes + rec_bytes <= inst_budget)
                if fuse:
                    from fastk_tpu.ops.count import unique_batch_inst

                    res = unique_batch_inst(
                        _upload_packed(pw, exc, blen), k, size)
                    inst_store[-1].append(
                        (off, size, res["s_words"], res["s_pos"]))
                    inst_bytes += rec_bytes
                else:
                    res = unique_batch(_upload_packed(pw, exc, blen), k,
                                       size)
                if pending is not None:
                    _finalize(*pending)
                pending = (res, size)
        if (retain_packed and inst_store and inst_store[-1]
                and len(inst_store[-1]) == len(packed_store[-1])):
            # every slice of this batch is instanced device-resident: the
            # profile pass will never re-upload it, so drop the packed
            # bytes (0.25 B/base of dead host RAM otherwise) but keep the
            # slice geometry the dispatcher checks
            packed_store[-1] = [(off, size, None, None, blen)
                                for off, size, _pw, _exc, blen
                                in packed_store[-1]]
        if verbose:
            print(f"  batch {len(metas)}: {metas[-1][1].shape[0]} reads, "
                  f"{int(metas[-1][1].sum())} bases", flush=True)
        del batch  # codes are not retained (the packed slices are 2bit/base)
    res = None  # the last slice's full-size arrays live in `pending` only
    if pending is not None:
        _finalize(*pending)
        pending = None

    nreads = sum(len(m[1]) for m in metas)
    nshort = sum(int((m[1] < k).sum()) for m in metas)
    totlen = sum(int(m[1].sum()) for m in metas)

    if relative_table is not None:
        # relative profiles: no counting pass at all, only the join
        t_words, t_counts = _device_table(relative_table, k)
        sink = _ProfSink(k, out_base, out_nparts, nreads)
        _join_profiles_packed(metas, packed_store, k, t_words, t_counts,
                              sink)
        sink.close()
        return CountOutput(k, None, None, sink.profs, nreads, totlen,
                           nshort=nshort)

    # final device merge of all unique blocks
    total = sum(int(b.shape[0]) for b in blocks_counts)
    cap = 1 << max(15, math.ceil(math.log2(max(total, 2))))
    m_words = []
    for j in range(W):
        parts = [blk[j] for blk in blocks_words]
        parts.append(jnp.full(cap - total, 0xFFFFFFFF, jnp.uint32))
        m_words.append(jnp.concatenate(parts))
    m_counts = jnp.concatenate(
        blocks_counts + [jnp.zeros(cap - total, jnp.int32)])
    # the concatenation holds every block: free them before the merge sort
    del parts
    blocks_words.clear()
    blocks_counts.clear()
    merged = merge_unique_blocks(tuple(m_words), m_counts, cap, k)
    del m_words, m_counts

    hist_arr = np.asarray(merged["hist"]).astype(np.int64)
    overflow = nvalid_total - int(
        (hist_arr[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
    hist = Histogram.from_bins(k, hist_arr, overflow)

    table = None
    table_entries = None
    if table_min is not None:
        if table_min > 1:
            # compact the >= table_min entries ON DEVICE before fetching:
            # at -t3 on shotgun data most uniques are below threshold
            # (singletons/doubletons are the error tail), so the fetch
            # shrinks several-fold — a stable 1-bit compaction sort, the
            # standard cheap primitive from the ops cost table
            from fastk_tpu.ops.count import compact_table_min

            kept = compact_table_min(
                merged["seg_words"], merged["seg_counts"], table_min)
            nkeep = int(kept["nkeep"])
            u_words = np.stack(
                [np.asarray(w[:nkeep]) for w in kept["words"]], axis=1)
            u_counts = np.asarray(kept["counts"][:nkeep]).astype(np.uint16)
            keepm = slice(None)
        else:
            nuniq = int(merged["nuniq"])
            u_words = np.stack(
                [np.asarray(w[:nuniq]) for w in merged["seg_words"]],
                axis=1)
            u_counts = np.minimum(np.asarray(merged["seg_counts"][:nuniq]),
                                  HIST_HIGH).astype(np.uint16)
            keepm = u_counts >= table_min
        packed = words_to_packed(u_words[keepm], k)
        tab = KmerTable(k, table_min, packed, u_counts[keepm])
        table_entries = len(tab)
        if out_base is not None:
            from fastk_tpu.formats.ktab import write_ktab

            write_ktab(out_base, tab, nparts=out_nparts)
        else:
            table = tab
        del u_words, u_counts, tab

    profs = None
    if profiles:
        # join against the device-resident merged table (cutoff 1)
        nuniq = int(merged["nuniq"])
        capt = _trim(nuniq)
        t_words = tuple(w[:capt] for w in merged["seg_words"])
        t_counts = jnp.minimum(merged["seg_counts"][:capt], HIST_HIGH)
        sink = _ProfSink(k, out_base, out_nparts, nreads)
        _join_profiles_any(metas, inst_store, packed_store, k, t_words,
                           t_counts, sink)
        sink.close()
        profs = sink.profs
    out = CountOutput(k, hist, table, profs, nreads, totlen,
                      nshort=nshort)
    out.table_entries = table_entries
    return out


def _count_single_hist(batch: ReadBatch, k: int, verbose: bool
                       ) -> CountOutput:
    """Single-batch histogram-only job: the lean hist_batch program (no
    segment compaction, no merge pass)."""
    from fastk_tpu.ops.count import hist_batch

    size = _round_size(len(batch.codes), k)
    codes = _pad_codes(batch, k, size)
    res = hist_batch(_device_codes(codes), k, size)
    if verbose:
        print(f"  batch 1 (hist-only): {batch.nreads} reads, "
              f"{batch.totlen} bases", flush=True)
    hist_arr = np.asarray(res["hist"]).astype(np.int64)
    nvalid = int(res["nvalid"])
    overflow = nvalid - int(
        (hist_arr[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
    hist = Histogram.from_bins(k, hist_arr, overflow)
    return CountOutput(k, hist, None, None, batch.nreads, batch.totlen,
                       nshort=int((np.asarray(batch.rlen) < k).sum()))


def _count_single_fused(batch: ReadBatch, k: int, table_min: Optional[int],
                        verbose: bool, out_base: Optional[str] = None,
                        out_nparts: int = 4) -> CountOutput:
    """Single-batch `-t -p` jobs: one count_batch call yields the histogram,
    the unique table AND the per-position counts (the reference's "profiles
    by sort inversion" fused into phase 2, count.c:619-1004)."""
    from fastk_tpu.ops.count import count_batch

    size = _round_size(len(batch.codes), k)
    codes = _pad_codes(batch, k, size)
    res = count_batch(_device_codes(codes), k, size, True, True)
    if verbose:
        print(f"  batch 1 (fused): {batch.nreads} reads, "
              f"{batch.totlen} bases", flush=True)

    hist_arr = np.asarray(res["hist"]).astype(np.int64)
    nvalid = int(res["nvalid"])
    overflow = nvalid - int(
        (hist_arr[1:] * np.arange(1, HIST_HIGH + 1, dtype=np.int64)).sum())
    hist = Histogram.from_bins(k, hist_arr, overflow)

    # valid segments are the slots before the (single, trailing) invalid one
    nseg = int(res["nseg"])
    nuniq = nseg - (1 if nvalid < size else 0)
    u_words = np.stack(
        [np.asarray(w[:nuniq]) for w in res["seg_words"]], axis=1)
    u_counts = np.minimum(np.asarray(res["seg_counts"][:nuniq]),
                          HIST_HIGH).astype(np.uint16)
    table = None
    table_entries = None
    if table_min is not None:
        keep = u_counts >= table_min
        tab = KmerTable(k, table_min, words_to_packed(u_words[keep], k),
                        u_counts[keep])
        table_entries = len(tab)
        if out_base is not None:
            from fastk_tpu.formats.ktab import write_ktab

            write_ktab(out_base, tab, nparts=out_nparts)
        else:
            table = tab

    from fastk_tpu.ops.pack import fetch_u16

    pos_counts = fetch_u16(res["pos_counts"])
    sink = _ProfSink(k, out_base, out_nparts, batch.nreads)
    sink.add_batch(batch.boff, batch.rlen, pos_counts)
    sink.close()
    out = CountOutput(k, hist, table, sink.profs, batch.nreads,
                      batch.totlen,
                      nshort=int((np.asarray(batch.rlen) < k).sum()))
    out.table_entries = table_entries
    return out


def _join_profiles(batches, k, t_words, t_counts) -> List[np.ndarray]:
    """Join per-position counts for in-memory ReadBatches (the multi-chip
    host path keeps its batches); returns per-read count arrays."""
    sink = _ProfSink(k, None, 1, sum(b.nreads for b in batches))
    for batch in batches:
        metas = [(np.asarray(batch.boff), np.asarray(batch.rlen),
                  len(batch.codes))]
        store = [list(_packed_slices(batch.codes, k))]
        _join_profiles_packed(metas, store, k, t_words, t_counts, sink)
    return sink.profs


def _join_profiles_any(metas, inst_store, packed_store, k, t_words,
                       t_counts, sink: _ProfSink) -> None:
    """Profile pass dispatcher: batches whose sorted instance streams were
    retained device-resident join via profile_join_inst (no re-upload, no
    canonical recompute, position order straight off the join); the rest
    re-upload their 2-bit packed slices (_join_profiles_packed)."""
    from fastk_tpu.ops.count import profile_join_inst
    from fastk_tpu.ops.pack import fetch_u16

    for i, ((boff, rlen, clen), pslices) in enumerate(
            zip(metas, packed_store)):
        islices = inst_store[i] if i < len(inst_store) else []
        if len(islices) != len(pslices) or not islices:
            islices.clear()  # free any partial retention before the join
            _join_profiles_packed([metas[i]], [pslices], k, t_words,
                                  t_counts, sink)
            continue
        pos_counts = np.zeros(clen, dtype=np.uint16)
        for off, size, s_words, s_pos in islices:
            pc = fetch_u16(profile_join_inst(
                t_words, t_counts, s_words, s_pos))
            take = min(size, clen - off)
            if take > 0:
                pos_counts[off: off + take] = pc[:take]
        sink.add_batch(boff, rlen, pos_counts)


def _join_profiles_packed(metas, packed_store, k, t_words, t_counts,
                          sink: _ProfSink) -> None:
    """Second pass: per-position counts via the device sort-merge join,
    uploading the RETAINED 2-bit packed slices (oversized batches run in
    overlapping device slices); finished batches go straight to the sink."""
    from fastk_tpu.ops.pack import fetch_u16

    for (boff, rlen, clen), slices in zip(metas, packed_store):
        pos_counts = np.zeros(clen, dtype=np.uint16)
        for off, size, pw, exc, blen in slices:
            pc = fetch_u16(profile_join(
                t_words, t_counts, _upload_packed(pw, exc, blen), k, size))
            take = min(size, clen - off)
            if take > 0:
                pos_counts[off: off + take] = pc[:take]
        sink.add_batch(boff, rlen, pos_counts)


def count_reads(reads: List[bytes], k: int, **kw) -> CountOutput:
    """Convenience for tests: count an in-memory list of raw reads."""
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "in.fasta")
        with open(p, "w") as f:
            for i, r in enumerate(reads):
                s = r.decode() if isinstance(r, (bytes, bytearray)) else r
                f.write(f">r{i}\n{s}\n")
        return count_files([p], k, **kw)
