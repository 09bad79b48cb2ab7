"""Multi-host (multi-process) execution scaffolding.

The reference scales across nodes by running FastK per file block and
merging tables afterwards (README.md:245-353 job plans). This design
instead runs ONE global mesh over all hosts' chips (SURVEY §2.4
multi-node → multi-host pjit):

- `jax.distributed.initialize` connects the processes (init_from_env);
- input files shard across hosts deterministically (shard_files), reads
  keep a global order (process-major, then file, then read);
- every host feeds only its ADDRESSABLE devices of the global mesh
  (jax.make_array_from_process_local_data), and the shard_map counting
  program (parallel.dist.sharded_count_fn) runs unchanged — its
  all_to_all keyspace routing crosses devices within a host and the
  network across hosts, inserted by XLA from the same code.

The production counting path lives in parallel.meshooc (owner-resident
cross-batch merges, per-chip keyspace spill, streamed per-host output
slices — bounded host memory at any input size); count_files_multihost
here is the in-RAM convenience wrapper over it. Single-process use
degrades gracefully (process_count == 1), which is how the driver's
dryrun exercises this path without real multi-host hardware.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import fastk_tpu.jaxenv  # noqa: F401  (compile cache rule)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fastk_tpu.ops.kmers import pad_needed


def init_from_env() -> Tuple[int, int]:
    """Initialize jax.distributed from FASTK_TPU_COORD / _NPROCS / _PROC
    (no-op when unset or already initialized). Returns (pid, nprocs).

    The env check comes FIRST: jax.distributed.initialize must run before
    ANY backend-initializing JAX call (even jax.process_count()), or it
    raises. Only after initialize (or when the env is unset) is it safe
    to query the process topology."""
    coord = os.environ.get("FASTK_TPU_COORD")
    if coord and "FASTK_TPU_NPROCS" in os.environ:
        try:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=int(os.environ["FASTK_TPU_NPROCS"]),
                process_id=int(os.environ["FASTK_TPU_PROC"]),
            )
        except RuntimeError:
            pass  # already initialized (idempotent re-entry)
    return jax.process_index(), jax.process_count()


def shard_files(paths: Sequence[str], pid: int, nprocs: int) -> List[str]:
    """Deterministic per-host file assignment: size-descending greedy onto
    the least-loaded host (every process computes the same plan)."""
    sizes = []
    for p in paths:
        try:
            sizes.append(os.path.getsize(p))
        except OSError:
            sizes.append(0)
    order = sorted(range(len(paths)), key=lambda i: (-sizes[i], i))
    load = [0] * nprocs
    mine: List[Tuple[int, str]] = []
    for i in order:
        h = min(range(nprocs), key=lambda j: (load[j], j))
        load[h] += sizes[i]
        if h == pid:
            mine.append((i, paths[i]))
    return [p for _, p in sorted(mine)]


def _local_shard_rows(codes: np.ndarray, k: int, mesh: Mesh,
                      shard_size: int) -> jax.Array:
    """This process's rows of the global (D_global * (shard+halo),) code
    array, assembled into a global jax.Array without any host holding the
    whole thing."""
    halo = pad_needed(k)
    local_devices = [d for d in mesh.devices.flat
                     if d.process_index == jax.process_index()]
    dl = len(local_devices)
    rows = np.full((dl, shard_size + halo), 4, dtype=np.uint8)
    for r in range(dl):
        lo = r * shard_size
        hi = min(len(codes), lo + shard_size + halo)
        if hi > lo:
            rows[r, : hi - lo] = codes[lo:hi]
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    D = mesh.devices.size
    return jax.make_array_from_process_local_data(
        sharding, rows.reshape(dl * (shard_size + halo)),
        (D * (shard_size + halo),))


def _allgather_ragged(arr: np.ndarray) -> List[np.ndarray]:
    """Gather a per-host variable-length array to every host (pads to the
    max length under the hood). Single-process: identity."""
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return [arr]
    n = np.array([arr.shape[0]], np.int64)
    ns = np.asarray(multihost_utils.process_allgather(n)).reshape(-1)
    cap = int(ns.max())
    pad_shape = (cap,) + arr.shape[1:]
    padded = np.zeros(pad_shape, dtype=arr.dtype)
    padded[: arr.shape[0]] = arr
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    return [gathered[i, : int(ns[i])] for i in range(len(ns))]


def count_files_multihost(
    paths: Sequence[str],
    k: int,
    mesh: Optional[Mesh] = None,
    table_min: Optional[int] = None,
    profiles: bool = False,
    batch_bases: int = 64 << 20,
    slack: float = 1.8,
    verbose: bool = False,
):
    """Convenience wrapper over the scale-out mesh path
    (parallel.meshooc.count_files_mesh) returning the COMPLETE result in
    RAM on every host.

    The mesh path keeps uniques owner-resident and spills out-of-core —
    nothing is gathered across hosts per round; only the FINAL per-host
    table slices (already merged and keyspace-disjoint) and profile lists
    are exchanged, once. For results too large for a single host's RAM,
    call count_files_mesh with ``out_base`` and splice the slice file-sets
    with fastcat instead (the reference's multi-node job plan,
    README.md:245-353)."""
    from fastk_tpu.formats.ktab import KmerTable
    from fastk_tpu.parallel.meshooc import count_files_mesh, default_mesh

    if mesh is None:
        mesh = default_mesh()
    out = count_files_mesh(paths, k, mesh=mesh, table_min=table_min,
                           profiles=profiles, batch_bases=batch_bases,
                           slack=slack, verbose=verbose)
    if jax.process_count() == 1:
        return out
    if table_min is not None:
        kb = (k + 3) // 4
        rec = np.concatenate(
            [out.table.packed,
             np.ascontiguousarray(out.table.counts, dtype="<u2"
                                  ).view(np.uint8).reshape(-1, 2)], axis=1)
        allrec = np.concatenate(_allgather_ragged(rec))  # pid order
        out.table = KmerTable(
            k, table_min, allrec[:, :kb],
            np.ascontiguousarray(allrec[:, kb:]).view("<u2").ravel())
    if profiles:
        lens = np.array([len(p) for p in out.profiles], np.int64)
        vals = (np.concatenate(out.profiles).astype(np.uint32)
                if out.profiles else np.zeros(0, np.uint32))
        glens = _allgather_ragged(lens)
        gvals = _allgather_ragged(vals)
        profs = []
        for ls, vs in zip(glens, gvals):
            off = 0
            for L in ls:
                profs.append(vs[off: off + int(L)].astype(np.uint16))
                off += int(L)
        out.profiles = profs
    return out
