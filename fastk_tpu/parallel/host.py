"""Host orchestration of the multi-chip counting step: shard placement,
splitter training, result extraction and host-side assembly."""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fastk_tpu.ops.kmers import nwords, pad_needed
from fastk_tpu.parallel.dist import (
    prefix_histogram,
    sharded_count_fn,
    splitters_from_prefix_hist,
)


def _shard_codes(codes: np.ndarray, k: int, mesh: Mesh, shard_size: int):
    D = mesh.devices.size
    halo = pad_needed(k)
    out = np.full((D, shard_size + halo), 4, dtype=np.uint8)
    for d in range(D):
        lo = d * shard_size
        hi = min(len(codes), lo + shard_size + halo)
        if hi > lo:
            out[d, : hi - lo] = codes[lo:hi]
    flat = out.reshape(D * (shard_size + halo))
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return jax.device_put(flat, sharding)


def train_splitters(codes: np.ndarray, k: int, mesh: Mesh,
                    sample: int = 1 << 20, bits: int = 10,
                    exact: bool = False) -> np.ndarray:
    """Train keyspace splitters on a sample (single-chip prefix histogram).

    The analog of the reference's minimizer-scheme trainer on the first
    ~1Gbp block (Determine_Scheme, split.c:491-803).

    exact: place splitters at empirical word0 quantiles of the sample
    (full 32-bit resolution) instead of `bits`-bit prefix-histogram
    boundaries — the rebalance path uses this, since a single hot prefix
    can exceed a chip's bucket at any histogram granularity."""
    D = mesh.devices.size
    if D == 1:
        return np.zeros(0, dtype=np.uint32)
    n = min(len(codes), sample)
    size = 1 << max(15, int(np.ceil(np.log2(max(n, 2)))))
    buf = np.full(size + pad_needed(k), 4, dtype=np.uint8)
    buf[:n] = codes[:n]
    if not exact:
        ph = np.asarray(prefix_histogram(jnp.asarray(buf), k, size, bits))
        return splitters_from_prefix_hist(ph, D)

    from fastk_tpu.ops.count import fold_invalid
    from fastk_tpu.ops.kmers import canonical_kmers

    @jax.jit
    def w0_sorted(c):
        words, invalid = canonical_kmers(c, k, size)
        f0 = fold_invalid((words[0],), invalid)[0]
        # unstable: no payload, and the stable default costs a hidden
        # iota tiebreak operand
        return jax.lax.sort((f0,), num_keys=1, is_stable=False)[0]

    sw = np.asarray(w0_sorted(jnp.asarray(buf)))
    nvalid = int(np.searchsorted(sw, 0xFFFFFFFF))
    if nvalid == 0:
        return splitters_from_prefix_hist(
            np.ones(1 << bits, np.int64), D)
    # exclusive upper bounds: chip d owns w0 in [spl[d-1], spl[d])
    return sw[[min(nvalid - 1, nvalid * t // D)
               for t in range(1, D)]].astype(np.uint32)


def count_files_sharded(
    paths,
    k: int,
    mesh: Mesh,
    table_min: Optional[int] = None,
    profiles: bool = False,
    batch_bases: int = 64 << 20,
    verbose: bool = False,
    relative_table=None,
):
    """Multi-chip version of pipeline.count.count_files.

    Each batch's code stream shards data-parallel across the mesh, keys
    route by range across the mesh, and each chip merges ITS keyspace range
    across batches (owner-resident, spilled out-of-core between rounds —
    parallel.meshooc.count_files_mesh, which this delegates to). Chip
    order == key order, so the per-chip outputs concatenate into the
    globally sorted table. Returns a CountOutput."""
    if relative_table is not None:
        # -p:<table> mode: profiles against the given table, no counting
        return relative_profiles_sharded(
            paths, relative_table, mesh, batch_bases=batch_bases,
            verbose=verbose)

    from fastk_tpu.parallel.meshooc import count_files_mesh

    return count_files_mesh(list(paths), k, mesh=mesh, table_min=table_min,
                            profiles=profiles, batch_bases=batch_bases,
                            verbose=verbose)


def relative_profiles_sharded(
    paths,
    table,
    mesh: Mesh,
    batch_bases: int = 64 << 20,
    slack: float = 1.8,
    verbose: bool = False,
    out_base: Optional[str] = None,
    out_nparts: int = 4,
):
    """Multi-chip/multi-host `-p:<table>`: profiles of the input reads
    RELATIVE to a reference table (count = table count, or 0 if absent).

    The table is range-partitioned across chips at its own word0 quantiles
    (it is sorted, so the quantiles are exact) and stays chip-resident for
    every batch; each batch's queries route to their owner chip across the
    mesh. Multi-process runs shard the input files across hosts
    (process-major read order) and proceed in lockstep rounds; each host
    only materializes ITS chips' table rows. With ``out_base`` profiles
    stream per batch through ProfWriter (per-host slice file-sets when
    multi-process, spliced by fastcat); otherwise the host's own reads'
    profiles return in the CountOutput."""
    import jax

    from fastk_tpu.formats.ktab import KmerTable  # noqa: F401 (doc types)
    from fastk_tpu.formats.prof import ProfWriter, encode_profiles_bulk
    from fastk_tpu.io.reader import batched_reads
    from fastk_tpu.ops.count import HIST_HIGH
    from fastk_tpu.ops.kmers import packed_to_words
    from fastk_tpu.parallel.dist import sharded_relative_fn
    from fastk_tpu.parallel.multihost import _local_shard_rows, shard_files
    from fastk_tpu.pipeline.count import CountOutput, _profiles_from_positions

    k = table.kmer
    D = mesh.devices.size
    W = nwords(k)
    pid, nprocs = jax.process_index(), jax.process_count()
    my_paths = (shard_files(list(paths), pid, nprocs) if nprocs > 1
                else list(paths))
    local_devices = [d for d in mesh.devices.flat
                     if d.process_index == pid]
    n_local = len(local_devices)
    words = packed_to_words(table.packed, k)
    n = words.shape[0]

    # range-partition the (sorted) table at its word0 quantiles; the router
    # computes dest = #{splitters <= word0} (searchsorted side="right",
    # _route_chip), i.e. splitters are EXCLUSIVE upper bounds of each chip —
    # so the table cut for chip d is the first row with word0 >= splitter
    # (side="left"), keeping ownership consistent
    if D > 1 and n:
        splitters = words[:, 0][
            [min(n - 1, n * t // D) for t in range(1, D)]].astype(np.uint32)
    else:
        splitters = np.zeros(max(D - 1, 0), dtype=np.uint32)
    cuts = [0] + [int(np.searchsorted(words[:, 0], s, side="left"))
                  for s in splitters] + [n]
    table_cap = 1 << max(15, int(np.ceil(np.log2(max(
        max(cuts[d + 1] - cuts[d] for d in range(D)), 2)))))
    # each host materializes only ITS chips' table rows (every host reads
    # the same table file, so the cuts agree)
    chip_ids = {d: i for i, d in enumerate(mesh.devices.flat)}
    my_chips = sorted(chip_ids[d] for d in local_devices)
    twl = np.full((n_local, table_cap, W), 0xFFFFFFFF, dtype=np.uint32)
    tcl = np.zeros((n_local, table_cap), dtype=np.int32)
    for r, d in enumerate(my_chips):
        lo, hi = cuts[d], cuts[d + 1]
        twl[r, : hi - lo] = words[lo:hi]
        tcl[r, : hi - lo] = np.minimum(table.counts[lo:hi], HIST_HIGH)
    axis_sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    t_words = tuple(jax.make_array_from_process_local_data(
        axis_sharding, np.ascontiguousarray(twl[:, :, j]), (D, table_cap))
        for j in range(W))
    t_counts = jax.make_array_from_process_local_data(
        axis_sharding, tcl, (D, table_cap))
    spl = jax.device_put(jnp.asarray(splitters), NamedSharding(mesh, P()))

    fn = None
    shard_size = 0
    cur_slack = slack
    profs: Optional[list] = None
    stream = out_base is not None
    slice_base = (out_base if (out_base is None or nprocs == 1)
                  else f"{out_base}.{pid}")
    if not stream:
        profs = []
    # streamed: encoded blocks spool to DISK until the read count is known
    # (ProfWriter fixes its part cuts from the total up front), then replay
    # in bounded chunks — host RAM stays O(batch)
    spool_d = spool_l = None
    if stream:
        spool_d = open(slice_base + ".profspool", "w+b")
        spool_l = open(slice_base + ".lenspool", "w+b")
    nreads = totlen = 0
    step = 1 << 14

    def _spool_cleanup():
        for f, suff in ((spool_d, ".profspool"), (spool_l, ".lenspool")):
            try:
                f.close()
            except OSError:
                pass
            try:
                import os

                os.unlink(slice_base + suff)
            except OSError:
                pass

    def _my_pos_counts(out, nlocal_codes):
        rows = sorted(((chip_ids[s.device], np.asarray(s.data).reshape(-1))
                       for s in out["pos_counts"].addressable_shards),
                      key=lambda t: t[0])
        pc = np.concatenate([r[1] for r in rows])
        return pc[:nlocal_codes].astype(np.int32)

    gen = (b for b, _ in batched_reads(my_paths, batch_bases))
    batch = next(gen, None)
    try:
        while True:
            have = 0 if batch is None else 1
            need = (0 if batch is None
                    else ((max(len(batch.codes), D) + n_local - 1) // n_local))
            if nprocs > 1:
                from jax.experimental import multihost_utils

                flags = np.asarray(multihost_utils.process_allgather(
                    np.array([have, need], np.int64)))
                if int(flags[:, 0].max()) == 0:
                    break
                need = int(flags[:, 1].max())
            elif batch is None:
                break
            need = ((need + step - 1) // step) * step
            if fn is None or need > shard_size:
                shard_size = max(need, 2 * shard_size)
                fn = sharded_relative_fn(mesh, k, shard_size, table_cap,
                                         slack=cur_slack)
            codes = (batch.codes if batch is not None
                     else np.full(16, 4, np.uint8))
            out = fn(_local_shard_rows(codes, k, mesh, shard_size), spl,
                     t_words, t_counts)
            while int(out["route_overflow"]) > 0 and D > 1 and cur_slack < D:
                # capacity escalation (table ownership is fixed by its own
                # quantiles, so boundaries never move; slack == D always fits)
                cur_slack = min(2 * cur_slack, D)
                fn = sharded_relative_fn(mesh, k, shard_size, table_cap,
                                         slack=cur_slack)
                out = fn(_local_shard_rows(codes, k, mesh, shard_size), spl,
                         t_words, t_counts)
            if int(out["route_overflow"]) > 0:
                raise RuntimeError("bucket capacity exceeded; raise slack")
            if batch is not None:
                pc = np.minimum(_my_pos_counts(out, len(codes)), HIST_HIGH)
                if stream:
                    plen = np.maximum(np.asarray(batch.rlen) - k + 1, 0)
                    blob, offs = encode_profiles_bulk(
                        pc.astype(np.uint16), np.asarray(batch.boff)[:-1], plen)
                    np.ascontiguousarray(blob, np.uint8).tofile(spool_d)
                    np.diff(offs, prepend=0).astype("<i8").tofile(spool_l)
                else:
                    profs.extend(_profiles_from_positions(batch, pc, k))
                nreads += batch.nreads
                totlen += batch.totlen
                if verbose:
                    print(f"  sharded relative batch: {batch.nreads} reads",
                          flush=True)
            del batch
            batch = next(gen, None)

        if stream:
            pw = ProfWriter(slice_base, k, nreads,
                            nparts=min(out_nparts, max(1, nreads)))
            spool_d.flush()
            spool_l.flush()
            spool_d.seek(0)
            spool_l.seek(0)
            chunk = 1 << 16  # reads per replay block
            done = 0
            while done < nreads:
                lens = np.fromfile(spool_l, dtype="<i8",
                                   count=min(chunk, nreads - done))
                offs = np.cumsum(lens)
                blob = np.fromfile(spool_d, dtype=np.uint8,
                                   count=int(offs[-1]) if len(offs) else 0)
                pw.add_block(blob, offs)
                done += len(lens)
            pw.close()
            _spool_cleanup()
    except BaseException:
        if stream:
            _spool_cleanup()
        raise
    if nprocs > 1:
        from jax.experimental import multihost_utils

        tot = np.asarray(multihost_utils.process_allgather(
            np.array([nreads, totlen], np.int64)))
        nreads_g, totlen_g = int(tot[:, 0].sum()), int(tot[:, 1].sum())
    else:
        nreads_g, totlen_g = nreads, totlen
    res = CountOutput(k, None, None, profs, nreads_g, totlen_g)
    res.slice_base = slice_base
    res.slice_nreads = nreads
    return res


def sharded_count(
    codes: np.ndarray,
    k: int,
    mesh: Mesh,
    splitters: Optional[np.ndarray] = None,
    want_positions: bool = False,
    slack: float = 1.8,
    rebalance_state: Optional[dict] = None,
    auto_rebalance: bool = True,
    verbose: bool = False,
):
    """Count canonical k-mers of one host code stream across the mesh.

    Returns (words (n,W) uint32 sorted, counts int64, hist_arr int32[32768],
    overflow int, pos_counts int32[len(codes)] or None).

    Adaptive rebalance: when keyspace routing overflows a chip's bucket
    (splitters trained on an earlier, differently-composed sample — the
    reference refines its trie the same way, split.c:437-472), splitters
    retrain on THIS stream and the batch retries; a second overflow retries
    once more with doubled slack before failing. Results are unaffected:
    every batch's output is globally key-sorted whatever the splitters.
    rebalance_state (a dict) carries retrained splitters to later batches.
    """
    D = mesh.devices.size
    W = nwords(k)
    shard_size = (len(codes) + D - 1) // D
    step = 1 << 14
    shard_size = ((shard_size + step - 1) // step) * step

    if rebalance_state is not None and "splitters" in rebalance_state:
        splitters = rebalance_state["splitters"]
    if splitters is None:
        splitters = train_splitters(codes, k, mesh)

    def put_spl(s):
        return jax.device_put(jnp.asarray(s, dtype=jnp.uint32),
                              NamedSharding(mesh, P()))

    fn = sharded_count_fn(mesh, k, shard_size, slack=slack,
                          want_positions=want_positions)
    codes_dev = _shard_codes(codes, k, mesh, shard_size)
    out = fn(codes_dev, put_spl(splitters))
    route_ovf = int(out["route_overflow"])
    if route_ovf > 0 and D > 1 and auto_rebalance:
        # retrain on the full current stream at exact word0 quantiles
        splitters = train_splitters(codes, k, mesh, sample=len(codes),
                                    exact=True)
        if rebalance_state is not None:
            rebalance_state["splitters"] = splitters
        if verbose:
            print(f"  route overflow ({route_ovf} records): splitters "
                  "retrained on current batch", flush=True)
        out = fn(codes_dev, put_spl(splitters))
        route_ovf = int(out["route_overflow"])
    if route_ovf > 0 and D > 1 and auto_rebalance:
        fn2 = sharded_count_fn(mesh, k, shard_size, slack=min(2 * slack, D),
                               want_positions=want_positions)
        if verbose:
            print("  still overflowing: retrying with doubled slack",
                  flush=True)
        out = fn2(codes_dev, put_spl(splitters))
        route_ovf = int(out["route_overflow"])
    if route_ovf > 0:
        raise RuntimeError(
            f"bucket capacity exceeded by {route_ovf} records; "
            "retrain splitters or raise slack")

    # extract per-chip segments; chip order == key order
    nseg = np.asarray(out["nseg"])
    seg_valid = np.asarray(out["seg_valid"])
    seg_counts = np.asarray(out["seg_counts"])
    seg_words = [np.asarray(w) for w in out["seg_words"]]
    words_list, counts_list = [], []
    for d in range(D):
        ns = int(nseg[d])
        v = seg_valid[d, :ns]
        words_list.append(
            np.stack([w[d, :ns][v] for w in seg_words], axis=1)
            if ns else np.zeros((0, W), np.uint32))
        counts_list.append(seg_counts[d, :ns][v].astype(np.int64))
    words = np.concatenate(words_list) if words_list else np.zeros((0, W), np.uint32)
    counts = np.concatenate(counts_list) if counts_list else np.zeros(0, np.int64)

    hist_arr = np.asarray(out["hist"])
    overflow = int(out["overflow"])

    pos_counts = None
    if want_positions:
        pc = np.asarray(out["pos_counts"]).reshape(D, shard_size)
        pos_counts = pc.reshape(-1)[: len(codes)]
    return words, counts, hist_arr, overflow, pos_counts
