"""Multi-chip k-mer counting with shard_map over a device mesh.

Design (replaces the reference's NPARTS disk buckets + file stripes,
split.c:1419-1490, and the multi-node Fastmerge flow, README.md:245-353):

- Reads are data-parallel: each chip gets a shard of the code stream.
- The canonical keyspace is RANGE-partitioned across chips. Routing by key
  range (instead of the reference's minimizer buckets) means every instance
  of a k-mer lands on exactly one chip, so per-chip segment counts are
  globally exact with no cross-chip merge, and the concatenation of per-chip
  sorted uniques is the final sorted table — no re-shard before table
  emission.
- The bucket exchange is one jax.lax.all_to_all; the histogram is a psum;
  profile counts return to their source chip by the inverse all_to_all.
- Range splitters are trained on a first-batch prefix histogram (the analog
  of the reference's core-prefix-trie trainer, split.c:491-803), so skewed
  data still balances.

Routing capacity: all_to_all needs equal-size blocks, so each chip sends
cap = ceil(S/D)*slack slots per destination; overflow beyond the capacity is
counted and surfaces as a (checked) overflow counter so callers can re-train
splitters / raise slack.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fastk_tpu.ops.kmers import canonical_kmers, nwords


def make_mesh(n_devices: Optional[int] = None, axis: str = "d") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def default_splitters(ndev: int) -> np.ndarray:
    """Uniform split of the 32-bit word0 space (upper bounds per chip).

    Canonical keys are skewed toward the lower half (min(fwd, rc)), so train
    splitters with prefix_histogram for real runs.
    """
    edges = (np.arange(1, ndev) * (1 << 32) // ndev).astype(np.uint32)
    return edges


def splitters_from_prefix_hist(prefix_hist: np.ndarray, ndev: int) -> np.ndarray:
    """Quantile splitters (upper bounds, exclusive, on word0) from a 2^B-bin
    histogram of word0 top bits (the trainer analog of assign_pieces,
    split.c:289-381)."""
    B = int(np.log2(len(prefix_hist)))
    c = np.cumsum(prefix_hist.astype(np.float64))
    total = c[-1] if c[-1] > 0 else 1.0
    edges = []
    for t in range(1, ndev):
        target = total * t / ndev
        b = int(np.searchsorted(c, target))
        edges.append(min(b + 1, (1 << B) - 1) << (32 - B))
    return np.array(edges, dtype=np.uint32)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def prefix_histogram(codes: jnp.ndarray, k: int, size: int, bits: int = 8):
    """Histogram of the top `bits` of canonical word0 over one shard."""
    words, invalid = canonical_kmers(codes, k, size)
    b = (words[0] >> (32 - bits)).astype(jnp.int32)
    return jnp.zeros(1 << bits, jnp.int32).at[
        jnp.where(invalid == 0, b, 0)
    ].add(jnp.where(invalid == 0, 1, 0))


def _place_slots(flat, operands, n_slots: int):
    """Dense [n_slots] lanes from records at distinct slots `flat`; dropped
    records hold flat == n_slots and land in a dump slot that is cut off.
    One scatter per operand (on one H100 at 2^26 positions and 4 lanes the
    whole routing step took 64.5 ms with it, against 619.5 ms for the
    sort-based placement it replaced)."""
    out = []
    for v in operands:
        buf = jnp.zeros(n_slots + 1, v.dtype)
        out.append(buf.at[flat].set(v)[:-1])
    return out


def _route_chip(words, invalid, pos, splitters, ndev: int, cap: int, size: int,
                carry_pos: bool = False, weights=None):
    """Build the [ndev, cap] send buffers for one chip's positions.

    Records are grouped by destination with one value-carrying sort; each
    gets slot dest*cap + rank-within-dest. Returns the send buffers plus
    (orig, flat): the original position and send slot of each routed record,
    for the inverse (profile-count) exchange.

    carry_pos: also place each record's original position into a send
    buffer (send_pos), so the OWNER chip learns where each instance came
    from — the out-of-core mesh profile path spills (key, src, pos)
    instance records on the owner (the analog of the reference carrying
    super-mer ordinals into its bucket files, split.c:1167-1277).
    """
    from fastk_tpu.ops.count import fill_forward, sort_records

    dest = jnp.searchsorted(splitters, words[0], side="right").astype(jnp.uint32)
    dest = jnp.where(invalid == 0, dest, ndev)  # invalid -> dropped

    (d_sorted,), _, carried = sort_records(
        (dest,), jnp.zeros(size, jnp.uint32),
        (*words, pos, *(() if weights is None
                        else (weights.astype(jnp.uint32),))))
    ws = carried[: len(words)]
    orig = carried[len(words)]
    s_weights = carried[len(words) + 1] if weights is not None else None

    # rank within destination: distance from the first record of the same
    # dest, via the gather-free fill-forward
    idx = jnp.arange(size, dtype=jnp.int32)
    d_starts = (d_sorted != jnp.roll(d_sorted, 1)).at[0].set(True)
    first_of = jnp.maximum(fill_forward(d_starts, idx, size), 0)
    rank = idx - first_of

    routed = d_sorted < ndev
    slot_ok = (rank < cap) & routed
    overflow = jnp.sum((rank >= cap) & routed)

    flat = jnp.where(slot_ok, d_sorted.astype(jnp.int32) * cap + rank, ndev * cap)

    # pre-deduplicated records ride with their local counts: the placed
    # buffer then doubles as (weight, validity) — empty slots hold 0
    # exactly as with the plain ones marker
    ones = (jnp.ones(size, jnp.uint32) if weights is None else s_weights)
    vals = [*ws, *( (orig,) if carry_pos else () ), ones]
    placed = _place_slots(flat, vals, ndev * cap)
    placed = [p.astype(jnp.uint32).reshape(ndev, cap) for p in placed]
    send_words = tuple(placed[: len(ws)])
    send_pos = placed[len(ws)] if carry_pos else None
    send_valid = placed[-1]
    return send_words, send_valid, overflow, orig, flat, send_pos


def _slot_counts_to_routed(flat_counts, send_valid_flat, size: int):
    """Counts per ROUTED-ORDER record from per-send-slot counts, without
    an index-array gather.

    Send slots are assigned to routed records in increasing order (slot =
    dest*cap + rank follows the routed sort order), so a stable compaction
    of the USED slots' counts IS the placed records' counts in routed
    order; dropped (invalid) records trail the routed order and take the
    zero tail."""
    masked = jnp.where(send_valid_flat > 0,
                       flat_counts.astype(jnp.int32), 0)
    comp = jax.lax.sort(
        ((1 - send_valid_flat).astype(jnp.uint8), masked),
        num_keys=1, is_stable=True)[1]
    return comp[:size]


def _count_received(words, valid, D_cap: int, want_rec_counts: bool,
                    k: int = 0, pos=None, weighted: bool = False):
    """Sort + segment-count the received records on one chip.

    Records with valid==0 are padding; they sort to the end (valid is the
    most significant sort key, inverted). k enables the narrow uint16
    last sort operand (segmented_count widens its outputs back).

    pos: per-received-record source positions; when given, the key sort
    also carries (pos, slot) and the sorted instance stream is returned
    (inst_words folded/widened, inst_pos, inst_slot, n_inst) — padding and
    invalid records trail, so the first n_inst entries are the instances.

    weighted: `valid` holds per-record weights (pre-deduplicated local
    counts); segment counts are weight SUMS instead of run lengths."""
    from fastk_tpu.ops.count import (
        positions_inverse, segmented_count, sort_records, widen_words)

    inv = (valid == 0).astype(jnp.uint32)
    values = (jnp.arange(D_cap, dtype=jnp.uint32),) if want_rec_counts else ()
    if pos is not None:
        values = values + (pos.astype(jnp.uint32),
                           jnp.arange(D_cap, dtype=jnp.uint32))
    if weighted:
        values = values + (valid.astype(jnp.uint32),)
    s_words, s_inv, s_vals = sort_records(list(words), inv, values, k=k)
    s_weights = None
    if weighted:
        s_weights = s_vals[-1].astype(jnp.int32)
        s_vals = s_vals[:-1]
    res = segmented_count(s_words, jnp.zeros(D_cap, jnp.uint32), D_cap,
                          want_elem_counts=want_rec_counts, want_hist=True,
                          weights=s_weights)
    if want_rec_counts:
        elem = res.pop("elem_counts")
        # back to received-record order (for the inverse all_to_all)
        res["rec_counts"] = positions_inverse(s_vals[0], elem)
    if pos is not None:
        o = 1 if want_rec_counts else 0
        res["inst_words"] = widen_words(tuple(s_words), k)
        res["inst_pos"] = s_vals[o]
        res["inst_slot"] = s_vals[o + 1]
        # the per-instance segment index is NOT returned: hosts derive
        # it as repeat(arange(nseg_valid), seg_counts) — the instance
        # stream is the segments concatenated in order (the mesh spill
        # stores (seg_rel, pos, src) rows built that way)
        res["n_inst"] = jnp.sum(valid > 0).astype(jnp.int32)
    return res


def sharded_count_fn(mesh: Mesh, k: int, shard_size: int, slack: float = 1.6,
                     want_positions: bool = False, want_inst: bool = False,
                     pre_dedup: Optional[bool] = None):
    """Build the jitted multi-chip counting step.

    Input:  codes [D * shard_size] sharded along the mesh axis; splitters
            [D-1] uint32 (replicated).
    Output (all per-chip shards along axis 'd' unless noted):
      seg_words [D, cap*D] tuple, seg_counts, seg_valid, nseg [D],
      hist [32768] (replicated psum), overflow [] (replicated),
      route_overflow [] (replicated; must be 0 for exact results),
      pos_counts [D * shard_size] (if want_positions; count at each original
      position of the local shard),
      inst_words/inst_pos/inst_slot/n_inst (if want_inst; the owner-resident
      sorted instance stream: each chip's valid received records in key
      order with their source position and receive slot — slot // cap is
      the source chip. The out-of-core mesh profile path spills these).

    pre_dedup (opt-in; count-only): sort + segment-reduce each chip's
    shard LOCALLY before routing, exchanging (key, local-count) uniques
    instead of raw instances. Per-source routing volume is then bounded
    by the shard's unique keys, so a hot k-mer routes as ONE weighted
    record and the per-source receive lane cannot overflow on count skew
    — the role of the reference's super-mer dedup-before-weighted-sort
    (count.c:1-18), applied at the exchange. NOT the default: the local
    sort is pure overhead on balanced data (static shapes — the receive
    sort's operand size never shrinks), so the mesh driver enables it as
    an overflow-recovery mode (meshooc escalation ladder). Instances
    (want_inst) are intrinsically per-position and keep raw routing.
    """
    axis = mesh.axis_names[0]
    D = mesh.devices.size
    W = nwords(k)
    cap = int(shard_size // D * slack) if D > 1 else shard_size
    D_cap = D * cap
    dedup = bool(pre_dedup) and D > 1 and not (want_inst or want_positions)

    def step(codes, splitters):
        # codes: local shard [shard_size + pad]; positions are local
        words, invalid = canonical_kmers(codes, k, shard_size)
        pos = jnp.arange(shard_size, dtype=jnp.uint32)

        if D == 1:
            # no exchange: count the local shard directly
            rw, rv = words, (invalid == 0).astype(jnp.uint32)
            route_ovf = jnp.int32(0)
            res = _count_received(rw, rv, D_cap, want_positions, k=k,
                                  pos=pos if want_inst else None)
        else:
            from fastk_tpu.ops.count import (segmented_count, sort_records,
                                             widen_words)

            weights = None
            if dedup:
                s_words, _s_inv, _ = sort_records(list(words), invalid, k=k)
                lseg = segmented_count(
                    s_words, jnp.zeros(shard_size, jnp.uint32), shard_size)
                words = widen_words(lseg["seg_words"], k)
                invalid = (~lseg["seg_valid"]).astype(jnp.uint32)
                weights = lseg["seg_counts"]
            (send_words, send_valid, route_ovf, orig, flat, send_pos
             ) = _route_chip(words, invalid, pos, splitters, D, cap,
                            shard_size, carry_pos=want_inst,
                            weights=weights)
            recv_words = tuple(
                jax.lax.all_to_all(w, axis, 0, 0, tiled=False) for w in send_words
            )
            recv_valid = jax.lax.all_to_all(send_valid, axis, 0, 0, tiled=False)
            rw = tuple(w.reshape(D_cap) for w in recv_words)
            rv = recv_valid.reshape(D_cap)
            rpos = (jax.lax.all_to_all(send_pos, axis, 0, 0, tiled=False
                                       ).reshape(D_cap) if want_inst else None)
            res = _count_received(rw, rv, D_cap, want_positions, k=k,
                                  pos=rpos, weighted=dedup)

        hist = jax.lax.psum(res["hist"], axis) if D > 1 else res["hist"]
        overflow = jax.lax.psum(res["overflow"], axis) if D > 1 else res["overflow"]
        route_ovf = jax.lax.psum(route_ovf, axis) if D > 1 else route_ovf

        out = dict(
            seg_words=tuple(w[None] for w in res["seg_words"]),
            seg_counts=res["seg_counts"][None],
            seg_valid=res["seg_valid"][None],
            nseg=res["nseg"][None],
            hist=hist,
            overflow=overflow,
            route_overflow=route_ovf,
        )

        if want_inst:
            out["inst_words"] = tuple(w[None] for w in res["inst_words"])
            out["inst_pos"] = res["inst_pos"][None]
            out["inst_slot"] = res["inst_slot"][None]
            out["n_inst"] = res["n_inst"][None]

        if want_positions:
            if D == 1:
                pos_counts = res["rec_counts"]
            else:
                rc = res["rec_counts"].reshape(D, cap)
                back = jax.lax.all_to_all(rc, axis, 0, 0, tiled=False)
                # undo routing: compact used-slot counts back to routed
                # order, then one scatter by original position
                from fastk_tpu.ops.count import positions_inverse

                got = _slot_counts_to_routed(
                    back.reshape(D_cap), send_valid.reshape(D_cap),
                    shard_size)
                pos_counts = positions_inverse(orig, got)
            out["pos_counts"] = pos_counts[None]
        return out

    from jax import shard_map

    in_specs = (P(axis), P())
    out_specs = dict(
        seg_words=tuple(P(axis) for _ in range(W)),
        seg_counts=P(axis),
        seg_valid=P(axis),
        nseg=P(axis),
        hist=P(),
        overflow=P(),
        route_overflow=P(),
    )
    if want_positions:
        out_specs["pos_counts"] = P(axis)
    if want_inst:
        out_specs["inst_words"] = tuple(P(axis) for _ in range(W))
        out_specs["inst_pos"] = P(axis)
        out_specs["inst_slot"] = P(axis)
        out_specs["n_inst"] = P(axis)

    fn = shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


def sharded_relative_fn(mesh: Mesh, k: int, shard_size: int, table_cap: int,
                        slack: float = 1.6):
    """Build the jitted multi-chip RELATIVE-profile step (the -p:<table>
    job, reference split.c:1943-2131 + cmer_merge_thread count.c:675-792,
    multi-chip).

    The reference table is RANGE-partitioned across chips by the same
    splitters that route queries, so each chip owns the counts for its key
    interval: queries route to their owner (one all_to_all), the
    owner joins them against its chip-resident table shard (count = table
    count or 0), and the counts ride the inverse all_to_all back to query
    position order.

    Input:  codes [D * shard_size] sharded; splitters [D-1] replicated;
            table words tuple of W x [D, table_cap] sharded (all-ones empty
            slots); table counts [D, table_cap] sharded int32.
    Output: pos_counts [D * shard_size] sharded; route_overflow []
            (replicated; must be 0 for exact results).
    """
    axis = mesh.axis_names[0]
    D = mesh.devices.size
    W = nwords(k)
    cap = int(shard_size // D * slack) if D > 1 else shard_size
    D_cap = D * cap

    def step(codes, splitters, t_words, t_counts):
        from fastk_tpu.ops.count import (
            _join_counts, fold_invalid, positions_inverse)

        words, invalid = canonical_kmers(codes, k, shard_size)
        tw = tuple(w.reshape(-1) for w in t_words)
        tc = t_counts.reshape(-1)

        if D == 1:
            pos_counts = _join_counts(tw, tc, fold_invalid(words, invalid))
            return dict(pos_counts=pos_counts[None],
                        route_overflow=jnp.int32(0))

        pos = jnp.arange(shard_size, dtype=jnp.uint32)
        (send_words, send_valid, route_ovf, orig, flat, _sp) = _route_chip(
            words, invalid, pos, splitters, D, cap, shard_size)
        recv_words = tuple(
            jax.lax.all_to_all(w, axis, 0, 0, tiled=False)
            for w in send_words)
        recv_valid = jax.lax.all_to_all(send_valid, axis, 0, 0, tiled=False)
        rv = recv_valid.reshape(D_cap)
        q = fold_invalid(tuple(w.reshape(D_cap) for w in recv_words),
                         (rv == 0).astype(jnp.uint32))
        rec = _join_counts(tw, tc, q)                      # received order
        back = jax.lax.all_to_all(
            rec.reshape(D, cap), axis, 0, 0, tiled=False)
        got = _slot_counts_to_routed(
            back.reshape(D_cap), send_valid.reshape(D_cap), shard_size)
        pos_counts = positions_inverse(orig, got)
        return dict(pos_counts=pos_counts[None],
                    route_overflow=jax.lax.psum(route_ovf, axis))

    from jax import shard_map

    in_specs = (P(axis), P(), tuple(P(axis) for _ in range(W)), P(axis))
    out_specs = dict(pos_counts=P(axis), route_overflow=P())
    fn = shard_map(step, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


def pad_shards(codes: np.ndarray, k: int, mesh: Mesh, shard_size: int) -> np.ndarray:
    """Split a host code stream into D shards of shard_size (+k halo each).

    Each shard gets a (k-1)-code halo from the next shard so windows crossing
    the shard boundary are counted exactly once (by the owning shard) — the
    multi-chip analog of the reference's rem/next block split (io.c:296-333).
    """
    from fastk_tpu.ops.kmers import pad_needed

    D = mesh.devices.size
    halo = pad_needed(k)
    out = np.full((D, shard_size + halo), 4, dtype=np.uint8)
    for d in range(D):
        lo = d * shard_size
        hi = min(len(codes), lo + shard_size + halo)
        if hi > lo:
            out[d, : hi - lo] = codes[lo:hi]
        # windows beyond shard_size are the next shard's; mask them by
        # keeping only shard_size positions in canonical_kmers(size=...)
    return out.reshape(D * (shard_size + halo))
