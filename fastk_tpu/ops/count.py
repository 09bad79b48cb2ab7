"""Device-side k-mer counting: sort, segment reduction, histogram, inversion.

The reference's two-stage weighted sort (super-mer dedup then weighted k-mer
sort, count.c:1-18) exists to shrink CPU sort volume; here the sort is a
device-wide sort over fixed-shape key-word arrays, so we sort k-mer
instances directly and fold counting into a segmented reduction.

The path is built from sorts, cumulative sums, rolls and searchsorted; it
uses no gather by permutation, and one scatter: the inverse permutation.
These choices predate any measurement on the H100 (histogram and segment
broadcast each have a scatter or gather alternative still to be measured
there):

- invalid positions are encoded IN the key as all-ones words (a canonical
  k-mer can never be all-ones: the RC of T^k is A^k which is smaller), so the
  sort carries no separate invalid operand;
- per-segment sums come from one 1-bit compaction sort: exclusive-cumsum of
  the weights is carried through the compaction and differenced;
- the 32768-bin count histogram is a 1-key sort of clipped per-segment counts
  plus one searchsorted over the bin boundaries — no scatter;
- the reference's profile inversion by a pair of LSD sorts on ordinal indices
  (count.c:619-1004) is a single scatter by position.

All results are integers: no floating-point arithmetic is on this path.
"""

from __future__ import annotations

import functools
import jax
import jax.numpy as jnp

import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)

from fastk_tpu.ops.kmers import canonical_kmers

HIST_HIGH = 0x7FFF
import numpy as np

ONES = np.uint32(0xFFFFFFFF)  # numpy scalar: a fresh constant per trace
# (a jnp scalar would cache a mesh-bound aval and break nested shard_map use)
ONES16 = np.uint16(0xFFFF)


def _ones(w) -> np.generic:
    """The all-ones constant matching a key word's dtype."""
    return ONES16 if w.dtype == jnp.uint16 else ONES


def fold_invalid(words, invalid):
    """Encode invalid records as all-ones keys (sort last, need no flag).

    Safe because a canonical key is never all-ones in every word: canonical =
    min(fwd, rc) and an all-T k-mer canonicalizes to all-A (see module doc).
    """
    return tuple(jnp.where(invalid != 0, _ones(w), w) for w in words)


def is_invalid_key(words) -> jnp.ndarray:
    m = words[0] == _ones(words[0])
    for w in words[1:]:
        m = m & (w == _ones(w))
    return m


def narrow_words(words, k: int):
    """Halve the LAST sort operand when k leaves it <= 8 bases: the last key
    word holds 2L high-aligned bits (L = k mod 16), so for L <= 8 it carries
    only its top 16 bits — shift down into a uint16 operand, so e.g. k=40
    sorts (u32,u32,u16) instead of (u32,u32,u32): fewer bytes per record.
    Order and all-ones invalid folding are preserved (0xFFFFFFFF >> 16 with
    all-ones high half == 0xFFFF)."""
    W = len(words)
    L = k - 16 * (W - 1)
    if W >= 2 and L <= 8 and words[-1].dtype == jnp.uint32:
        return words[:-1] + ((words[-1] >> 16).astype(jnp.uint16),)
    return words


def widen_words(words, k: int):
    """Inverse of narrow_words: restore the left-aligned uint32 last word.

    All-ones sentinel slots (invalid records / empty block slots, all-ones
    in EVERY word) widen back to 0xFFFFFFFF, not 0xFFFF0000 — the
    documented sentinel invariant. A REAL key whose narrow last word is
    0xFFFF (a T^8 suffix) is distinguished by its other words."""
    if words and words[-1].dtype == jnp.uint16:
        wide = words[-1].astype(jnp.uint32) << 16
        sent = words[-1] == ONES16
        for w in words[:-1]:
            sent = sent & (w == ONES)
        return words[:-1] + (jnp.where(sent, ONES, wide),)
    return words


def sort_records(words, invalid, values=(), k: int = 0):
    """Sort records keyed by (invalid-folded words...) carrying `values`.

    Returns (s_words, s_invalid, s_values) ascending, invalid records last.
    Kept as the generic entry point for the multi-chip path. Pass k to
    enable the narrow uint16 last-operand (returned words stay narrowed;
    widen_words restores them)."""
    folded = fold_invalid(words, invalid)
    if k:
        folded = narrow_words(folded, k)
    ops = (*folded, *values)
    out = jax.lax.sort(ops, num_keys=len(folded), is_stable=False)
    s_words = out[: len(folded)]
    return s_words, is_invalid_key(s_words).astype(jnp.uint32), \
        out[len(folded):]


def segment_reduce(s_words, size: int, weights=None, carry_words: bool = False,
                   extra_values=()):
    """Segment statistics over SORTED (invalid-folded) keys.

    weights: int32 per-record weights to sum per segment (None -> run length).
    carry_words / extra_values: additionally compact the key words / extra
    per-record values to segment slots (slot j = j-th segment in key order).

    Returns dict:
      nseg        int32 scalar — number of segments (the trailing all-ones
                  invalid block, if present, is ONE of them)
      seg_counts  int32[size] — per-segment weight sums (0 beyond nseg)
      seg_start   int32[size] — start index of each segment (size beyond nseg)
      seg_words   tuple of uint32[size] (if carry_words)
      seg_extra   tuple (if extra_values)
      elem_seg    int32[size] — segment slot of every sorted record
    """
    starts = jnp.zeros(size, dtype=bool)
    for w in s_words:
        starts = starts | (w != jnp.roll(w, 1))
    starts = starts.at[0].set(True)
    nseg = jnp.sum(starts.astype(jnp.int32))

    idx = jnp.arange(size, dtype=jnp.int32)
    if weights is None:
        # unweighted: run length = distance between consecutive start
        # indices, so the compaction need not carry a cumsum operand
        carried = (idx,)
        total = jnp.int32(size)
    else:
        cs = jax.lax.cumsum(weights.astype(jnp.int32))
        carried = (idx, cs - weights)
        total = cs[-1]

    if carry_words:
        carried = carried + tuple(s_words)
    carried = carried + tuple(extra_values)

    key = (~starts).astype(jnp.uint8)
    # stability is needed (segments must stay in start order) but comes for
    # free: carried[0] is the strictly-increasing idx, so making it the
    # second sort key is equivalent to is_stable=True and avoids the
    # stable sort's hidden iota tiebreak operand
    out = jax.lax.sort((key, *carried), num_keys=2, is_stable=False)
    c_idx = out[1]

    slot = idx
    in_seg = slot < nseg
    seg_start = jnp.where(in_seg, c_idx, size)
    if weights is None:
        csx = seg_start
    else:
        csx = jnp.where(in_seg, out[2], total)
    csx_next = jnp.concatenate([csx[1:], jnp.full((1,), total, jnp.int32)])
    seg_counts = jnp.where(in_seg, csx_next - csx, 0)

    res = dict(nseg=nseg, seg_counts=seg_counts, seg_start=seg_start,
               elem_seg=jax.lax.cumsum(starts.astype(jnp.int32)) - 1)
    o = 2 if weights is None else 3
    if carry_words:
        W = len(s_words)
        res["seg_words"] = tuple(
            jnp.where(in_seg, w, _ones(w)) for w in out[o: o + W])
        o += W
    if extra_values:
        res["seg_extra"] = tuple(out[o:])
    return res


def fill_forward(markers: jnp.ndarray, values: jnp.ndarray, size: int
                 ) -> jnp.ndarray:
    """out[i] = values[j] at the largest j <= i with markers[j] (-1 if none).

    Log-step pointer jumping: ~log2(size) shifted selects, all elementwise —
    in place of a per-element gather or a segmented scan. values must be
    >= 0 (int32)."""
    v = jnp.where(markers, values.astype(jnp.int32) + 1, 0)
    idx = jnp.arange(size, dtype=jnp.int32)
    nsteps = max(1, (size - 1).bit_length())

    def body(k, v):
        step = jnp.left_shift(jnp.int32(1), k)
        shifted = jnp.where(idx >= step, jnp.roll(v, step), 0)
        return jnp.where(v != 0, v, shifted)

    return jax.lax.fori_loop(0, nsteps, body, v) - 1


def next_start_after(starts: jnp.ndarray, size: int) -> jnp.ndarray:
    """nxt_after[i] = smallest start index strictly greater than i (size if
    none) — the run-length primitive (seg_len = nxt_after - idx at starts).

    A reverse cummin of where(starts, idx, size), shifted left by one. Runs
    row-decomposed when the shape allows: (R, C) row scans plus an O(R)
    cross-row suffix-min fix (exact-equality checked in the golden
    suites)."""
    idx = jnp.arange(size, dtype=jnp.int32)
    nxt = jnp.where(starts, idx, size)
    R = 64
    if size % R == 0 and size // R >= R:
        rm = jax.lax.cummin(nxt.reshape(R, size // R), axis=1, reverse=True)
        suf = jax.lax.cummin(
            jnp.concatenate([rm[1:, 0], jnp.full((1,), size, jnp.int32)]),
            reverse=True)
        scan = jnp.minimum(rm, suf[:, None]).reshape(-1)
    else:
        scan = jax.lax.cummin(nxt, reverse=True)
    return jnp.concatenate([scan[1:], jnp.full((1,), size, jnp.int32)])


def bincount_by_sort(values: jnp.ndarray, nbins: int) -> jnp.ndarray:
    """Histogram WITHOUT scatter: 1-key sort + searchsorted on bin edges.

    values must already be clipped to [0, nbins); anything to exclude should
    be set >= nbins by the caller (but below 2^16 - sorting runs in uint16
    when nbins allows, which halves the sorted bytes)."""
    if nbins + 1 < (1 << 16):
        values = values.astype(jnp.uint16)
    # is_stable=False matters: lax.sort defaults to stable, which costs a
    # hidden iota tiebreak operand (one extra key)
    sv = jax.lax.sort((values,), num_keys=1, is_stable=False)[0]
    edges = jnp.searchsorted(sv, jnp.arange(nbins + 1, dtype=sv.dtype))
    return (edges[1:] - edges[:-1]).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(1, 2))
def hist_batch(codes: jnp.ndarray, k: int, size: int):
    """Lean histogram-only counting of one code stream (the `FastK -k` job).

    Returns dict(hist int32[32768] — hist[c] = unique canonical k-mers with
    clipped count c, hist[0] unused; nvalid int32 — valid k-mer instances).
    Host computes instance overflow = nvalid - sum(c * hist[c]).

    Unlike the general path this skips even the compaction sort: run lengths
    are read off AT the start positions (next-start scan minus index) and the
    whole [size] array goes to the uint16 bincount sort, with non-starts and
    the invalid tail mapped to the excluded sentinel bin."""
    words, invalid = canonical_kmers(codes, k, size)
    ninv = jnp.sum(invalid.astype(jnp.int32))
    f = narrow_words(fold_invalid(words, invalid), k)
    s_words = jax.lax.sort(f, num_keys=len(f), is_stable=False)

    starts = jnp.zeros(size, dtype=bool)
    for w in s_words:
        starts = starts | (w != jnp.roll(w, 1))
    starts = starts.at[0].set(True)

    idx = jnp.arange(size, dtype=jnp.int32)
    seg_len = next_start_after(starts, size) - idx

    # a start element is a valid k-mer segment unless it is in the all-ones
    # invalid tail (the tail starts at size - ninv)
    use = starts & (idx < size - ninv)
    vals = jnp.where(use, jnp.minimum(seg_len, HIST_HIGH), HIST_HIGH + 1)
    hist = bincount_by_sort(vals, HIST_HIGH + 1)
    return dict(hist=hist, nvalid=jnp.int32(size) - ninv)


@functools.partial(jax.jit, static_argnums=(1, 2))
def unique_batch(codes: jnp.ndarray, k: int, size: int):
    """Sorted unique canonical k-mers of one code stream with counts.

    Returns dict(seg_words tuple of uint32[size] (slot j = j-th unique key,
    all-ones beyond), seg_counts int32[size], nseg int32 (INCLUDING a trailing
    invalid segment if any input positions were invalid), nuniq int32 (number
    of real unique k-mers), nvalid int32)."""
    words, invalid = canonical_kmers(codes, k, size)
    ninv = jnp.sum(invalid.astype(jnp.int32))
    f = narrow_words(fold_invalid(words, invalid), k)
    s_words = jax.lax.sort(f, num_keys=len(f), is_stable=False)
    seg = segment_reduce(s_words, size, carry_words=True)
    has_inv = (ninv > 0).astype(jnp.int32)
    nuniq = seg["nseg"] - has_inv
    slot = jnp.arange(size, dtype=jnp.int32)
    seg_counts = jnp.where(slot < nuniq, seg["seg_counts"], 0)
    seg_words = widen_words(tuple(
        jnp.where(slot < nuniq, w, _ones(w)) for w in seg["seg_words"]), k)
    return dict(seg_words=seg_words, seg_counts=seg_counts, nseg=seg["nseg"],
                nuniq=nuniq, nvalid=jnp.int32(size) - ninv)


@functools.partial(jax.jit, static_argnums=(1, 2))
def unique_batch_inst(codes: jnp.ndarray, k: int, size: int):
    """unique_batch plus the sorted instance stream, for out-of-core
    profile spills: the SAME key sort additionally carries each record's
    position, so phase 1 can spill (key, position) instances routed to
    their keyspace part (replacing per-(part,batch) joins downstream).

    Extra keys: s_words (folded, ascending, invalid all-ones last) and
    s_pos (uint32 position of each sorted record); the first `nvalid`
    records are the valid instances."""
    words, invalid = canonical_kmers(codes, k, size)
    ninv = jnp.sum(invalid.astype(jnp.int32))
    f = narrow_words(fold_invalid(words, invalid), k)
    out = jax.lax.sort((*f, jnp.arange(size, dtype=jnp.uint32)),
                       num_keys=len(f), is_stable=False)
    s_words, s_pos = out[:-1], out[-1]
    seg = segment_reduce(s_words, size, carry_words=True)
    has_inv = (ninv > 0).astype(jnp.int32)
    nuniq = seg["nseg"] - has_inv
    slot = jnp.arange(size, dtype=jnp.int32)
    seg_counts = jnp.where(slot < nuniq, seg["seg_counts"], 0)
    seg_words = widen_words(tuple(
        jnp.where(slot < nuniq, w, _ones(w)) for w in seg["seg_words"]), k)
    # note for the out-of-core consumer: the per-instance segment index
    # is NOT returned — the instance stream is the concatenation of the
    # segments in order, so the host derives it for free as
    # repeat(arange(nuniq), seg_counts) from the counts it already
    # fetches; only s_pos (4B/instance) crosses the link
    return dict(seg_words=seg_words, seg_counts=seg_counts, nseg=seg["nseg"],
                nuniq=nuniq, nvalid=jnp.int32(size) - ninv,
                s_words=widen_words(s_words, k), s_pos=s_pos)


@functools.partial(jax.jit, static_argnums=(2,))
def compact_table_min(words, counts, tmin: int):
    """Stable-compact entries with count >= tmin to the front (key order
    preserved: inputs are key-sorted and the 1-bit compaction is stable),
    counts clipped at HIST_HIGH. Returns dict(words, counts, nkeep).

    The -t<min> table fetch then moves only the kept entries over the
    device->host link — at -t3 on shotgun data the error tail
    (singletons/doubletons) is most of the uniques, so the transfer
    shrinks several-fold (the reference filters in table_write_thread,
    count.c:564-616; here the filter runs before the bytes move)."""
    keep = (counts >= tmin).astype(jnp.uint8)
    clipped = jnp.minimum(counts, HIST_HIGH).astype(jnp.uint32)
    out = jax.lax.sort(((1 - keep), *words, clipped),
                       num_keys=1, is_stable=True)
    return dict(words=tuple(out[1:-1]), counts=out[-1],
                nkeep=jnp.sum(keep.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def merge_unique_blocks(words, counts, size: int, k: int = 0,
                        want_back: bool = False):
    """Merge concatenated per-batch unique blocks into global sorted uniques.

    words: tuple of W uint32[size] (all-ones = empty slot), counts int32[size]
    (0 at empty slots). Returns the same layout globally deduplicated, plus
    the device histogram of merged counts. Pass k to enable the narrow
    last-word sort operand (see narrow_words).

    want_back: additionally return rec_counts — each INPUT record's merged
    (global) count, clipped at HIST_HIGH, in input order. This is how the
    out-of-core profile path resolves instance counts WITHOUT a separate
    table join: instances reference their batch's spilled unique records
    by segment index, so the per-record merged count IS the instance
    count (replaces profile_join_keys' table+query sort and its query
    upload entirely). Gather-free: per-segment totals broadcast to
    records by two fill-forwards over the sorted order (start-prefix and
    end-prefix cumsums), then one scatter back to input order."""
    nw = narrow_words(words, k) if k else words
    vals_in = (counts,) + ((jnp.arange(size, dtype=jnp.uint32),)
                           if want_back else ())
    s = jax.lax.sort((*nw, *vals_in), num_keys=len(nw), is_stable=False)
    s_words, s_counts = s[: len(nw)], s[len(nw)]
    seg = segment_reduce(s_words, size, weights=s_counts, carry_words=True)
    # empty slots (all-ones keys, weight 0) form the trailing segment with
    # count 0 unless none exist; exclude empties AND anything with count 0
    inv_tail = is_invalid_key(tuple(w for w in seg["seg_words"]))
    slot = jnp.arange(size, dtype=jnp.int32)
    real = (slot < seg["nseg"]) & (~inv_tail) & (seg["seg_counts"] > 0)
    nuniq = jnp.sum(real.astype(jnp.int32))
    seg_counts = jnp.where(real, seg["seg_counts"], 0)
    seg_words = tuple(
        jnp.where(real, w, _ones(w)) for w in seg["seg_words"])
    if k:
        seg_words = widen_words(seg_words, k)
    vals = jnp.where(real, jnp.minimum(seg_counts, HIST_HIGH), HIST_HIGH + 1)
    hist = bincount_by_sort(vals, HIST_HIGH + 1)
    out = dict(seg_words=seg_words, seg_counts=seg_counts, nuniq=nuniq,
               hist=hist)
    if want_back:
        s_orig = s[len(nw) + 1]
        starts = jnp.zeros(size, dtype=bool)
        for w in s_words:
            starts = starts | (w != jnp.roll(w, 1))
        starts = starts.at[0].set(True)
        cs = jax.lax.cumsum(s_counts.astype(jnp.int32))
        # segment total at record i = cs[last record of its segment]
        #                           - cs[record before its segment start]
        cs_before = jnp.roll(cs, 1).at[0].set(0)
        cs_start = fill_forward(starts, cs_before, size)
        last = jnp.concatenate(
            [starts[1:], jnp.ones((1,), bool)])  # segment-final records
        cs_end = jnp.flip(fill_forward(jnp.flip(last), jnp.flip(cs), size))
        tot = jnp.minimum(cs_end - cs_start, HIST_HIGH)
        out["rec_counts"] = positions_inverse(s_orig, tot)
    return out


def _join_counts(table_words, table_counts, q_folded, q_pos=None):
    """Core sort-merge join: clipped table count of each query key, in
    query order (0 where the key is absent or all-ones). q_pos (uint32,
    a permutation of [0, size)) reorders the result: out[q_pos[i]] =
    count of query i — used by the instance-stream path, whose queries
    arrive in sorted-key order but whose output is wanted in position
    order (the reorder rides the join's own restore sort for free).

    A sort-merge join: table entries and query positions are sorted together
    keyed by (words..., pos') where pos' is 0 for table entries and i+1 for
    the query at position i — so each table entry leads its key's segment
    and the same operand later restores stream order with one 1-key sort.
    The count at each segment start (a table count, or 0 for an absent key)
    broadcasts to the whole segment by fill-forward. All-ones query keys
    share the segment of the table's all-ones empty slots, whose count is
    0 — so they get count 0 for free. Replaces the reference's per-bucket
    reference-table stream intersection (cmer_merge_thread, count.c:675-792).
    """
    W = len(table_words)
    A = table_counts.shape[0]
    size = q_folded[0].shape[0]
    N = A + size
    merged = tuple(
        jnp.concatenate([tw, qw]) for tw, qw in zip(table_words, q_folded))
    # counts are clipped 15-bit, so they ride BOTH sorts as uint16 operands
    # (sort cost is per operand byte) and return to host as uint16 (halves
    # the profile D2H, which is the production profile pipeline's ceiling)
    cnt = jnp.concatenate([
        jnp.minimum(table_counts, HIST_HIGH).astype(jnp.uint16),
        jnp.zeros(size, jnp.uint16)])
    # one operand doubles as the table-first tiebreak key AND the position:
    # table entries get 0, query at position i gets i+1
    qp = (jnp.arange(size, dtype=jnp.uint32) if q_pos is None
          else q_pos.astype(jnp.uint32))
    pos = jnp.concatenate([jnp.zeros(A, jnp.uint32), qp + 1])
    out = jax.lax.sort((*merged, pos, cnt), num_keys=W + 1, is_stable=False)
    s_words, s_pos, s_cnt = out[:W], out[W], out[W + 1]

    # the table entry (if any) leads its segment, so every element's count
    # is a fill-forward of the counts seen at segment starts — no segment
    # compaction or gather needed
    starts = jnp.zeros(N, dtype=bool)
    for w in s_words:
        starts = starts | (w != jnp.roll(w, 1))
    starts = starts.at[0].set(True)
    elem_cnt = jnp.maximum(fill_forward(starts, s_cnt, N), 0
                           ).astype(jnp.uint16)
    # inverse sort by the same combined key: the A table entries (pos 0)
    # land first, queries follow in position order
    by_pos = jax.lax.sort((s_pos, elem_cnt), num_keys=1, is_stable=False)[1]
    return by_pos[A: A + size]


@functools.partial(jax.jit, static_argnums=(3, 4))
def profile_join(table_words, table_counts, codes: jnp.ndarray, k: int,
                 size: int):
    """Per-position clipped counts of a code stream against a sorted table
    (see _join_counts). Invalid positions fold to all-ones keys -> count 0.

    table_words: tuple of W uint32[A], sorted unique keys, all-ones at empty
    slots; table_counts: int32[A], 0 at empty slots."""
    words, invalid = canonical_kmers(codes, k, size)
    return _join_counts(table_words, table_counts,
                        fold_invalid(words, invalid))


@jax.jit
def profile_join_keys(table_words, table_counts, q_words):
    """Join pre-computed (invalid-folded) query key words against a sorted
    table: clipped counts in query order. The out-of-core profile path uses
    this on spilled instance records — each instance visits exactly ONE
    part's join instead of every (part, batch) pair."""
    return _join_counts(table_words, table_counts, q_words)


@jax.jit
def profile_join_inst(table_words, table_counts, s_words, s_pos):
    """Join a batch's retained SORTED instance stream (from
    unique_batch_inst) against a sorted table: clipped uint16 counts in
    POSITION order. The fused multi-batch profile path: no re-upload, no
    canonical recompute, and the position restore rides the join's own
    second sort (s_words arrive already invalid-folded by the counting
    sort)."""
    return _join_counts(table_words, table_counts, s_words, q_pos=s_pos)


def positions_inverse(pos: jnp.ndarray, values: jnp.ndarray):
    """Return `values` reordered to position order (pos is a permutation).

    One scatter by position. XLA:GPU rewrites the equivalent value-carrying
    sort by position into this same scatter, and its rewrite mis-types
    uint16 values (an HLO verifier error), so the scatter is written out."""
    return jnp.zeros(values.shape, values.dtype).at[pos].set(
        values, unique_indices=True)


def segmented_count(s_words, s_inv, size: int, want_elem_counts: bool = False,
                    want_hist: bool = False, weights=None):
    """Compatibility wrapper over segment_reduce for the multi-chip path.

    Returns dict(seg_words, seg_counts, seg_valid, nseg, overflow[, hist]
    [, elem_counts]). s_inv marks records whose keys were NOT invalid-folded;
    pass zeros when keys already encode invalid as all-ones.

    weights: per-record int32 weights summed per segment instead of run
    lengths — the receive side of pre-routing-deduplicated exchange, where
    each record is a (key, local-count) pair (parallel.dist pre_dedup)."""
    assert not (want_elem_counts and weights is not None)
    folded = fold_invalid(s_words, s_inv)
    ninv = jnp.sum((is_invalid_key(folded) | (s_inv != 0)).astype(jnp.int32))
    seg = segment_reduce(folded, size, weights=weights, carry_words=True,
                         extra_values=())
    slot = jnp.arange(size, dtype=jnp.int32)
    inv_tail = is_invalid_key(seg["seg_words"])
    seg_valid = (slot < seg["nseg"]) & (~inv_tail)
    seg_counts = jnp.where(slot < seg["nseg"], seg["seg_counts"], 0)
    overflow = jnp.sum(
        jnp.where(seg_valid & (seg_counts > HIST_HIGH),
                  seg_counts - HIST_HIGH, 0))
    # restore full-width words for consumers (no-op unless narrowed)
    out = dict(seg_words=widen_words(seg["seg_words"], 0),
               seg_counts=seg_counts,
               seg_valid=seg_valid, nseg=seg["nseg"], overflow=overflow,
               elem_seg=seg["elem_seg"])
    if want_hist:
        vals = jnp.where(seg_valid, jnp.minimum(seg_counts, HIST_HIGH),
                         HIST_HIGH + 1)
        out["hist"] = bincount_by_sort(vals, HIST_HIGH + 1)
    if want_elem_counts:
        # count of each SORTED record's segment: run length read off at the
        # start positions, broadcast by fill-forward (never a gather)
        starts = jnp.zeros(size, dtype=bool)
        for w in folded:
            starts = starts | (w != jnp.roll(w, 1))
        starts = starts.at[0].set(True)
        idx = jnp.arange(size, dtype=jnp.int32)
        start_len = jnp.minimum(next_start_after(starts, size) - idx,
                                HIST_HIGH)
        elem = jnp.maximum(fill_forward(starts, start_len, size), 0)
        out["elem_counts"] = (
            elem * (is_invalid_key(folded) == 0)).astype(jnp.int32)
    return out


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def count_batch(codes: jnp.ndarray, k: int, size: int, want_positions: bool,
                want_hist: bool = False):
    """Count canonical k-mers of one code stream (full-feature single batch).

    Returns dict(seg_words, seg_counts, seg_valid, nseg, overflow[, hist]
    [, pos_counts]): slot j of seg_* is the j-th segment in key order;
    pos_counts[i] = clipped count of the k-mer starting at position i (0 at
    invalid positions)."""
    words, invalid = canonical_kmers(codes, k, size)
    values = (jnp.arange(size, dtype=jnp.uint32),) if want_positions else ()
    s_words, s_inv, s_vals = sort_records(words, invalid, values, k=k)
    out = segmented_count(s_words, jnp.zeros(size, jnp.uint32), size,
                          want_elem_counts=want_positions, want_hist=want_hist)
    out["nvalid"] = jnp.int32(size) - jnp.sum(invalid.astype(jnp.int32))
    if want_positions:
        # clipped counts ride the inverse sort and the D2H as uint16
        elem = out.pop("elem_counts").astype(jnp.uint16)
        out["pos_counts"] = positions_inverse(s_vals[0], elem)
    return out
