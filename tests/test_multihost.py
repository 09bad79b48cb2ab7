"""Multi-host scaffolding: single-process equivalence on the virtual mesh,
the file-shard planner, and a REAL 2-process jax.distributed run over CPU
(subprocesses with a localhost coordinator)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    rng = np.random.default_rng(21)
    d = tmp_path_factory.mktemp("mh")
    genome = rng.integers(0, 4, size=2000)
    paths = []
    for fno in range(3):
        p = d / f"part{fno}.fasta"
        with open(p, "w") as f:
            for i in range(30):
                s = int(rng.integers(0, len(genome) - 90))
                r = genome[s: s + 90]
                f.write(f">r{fno}_{i}\n{''.join('acgt'[c] for c in r)}\n")
        paths.append(str(p))
    return paths


def test_shard_files_partition():
    from fastk_tpu.parallel.multihost import shard_files

    paths = [f"/nonexistent/f{i}" for i in range(7)]
    got = [shard_files(paths, pid, 3) for pid in range(3)]
    flat = sorted(p for g in got for p in g)
    assert flat == sorted(paths)  # exact partition, no overlap


def test_multihost_single_process_matches(data):
    from fastk_tpu.parallel.multihost import count_files_multihost
    from fastk_tpu.pipeline.count import count_files

    mesh = Mesh(np.array(jax.devices()), ("d",))
    a = count_files(data, 17, table_min=1, batch_bases=3000)
    b = count_files_multihost(data, 17, mesh=mesh, table_min=1,
                              batch_bases=3000)
    assert a.hist == b.hist
    assert np.array_equal(a.table.packed, b.table.packed)
    assert np.array_equal(a.table.counts, b.table.counts)
    assert (a.nreads, a.totlen) == (b.nreads, b.totlen)


_WORKER = r"""
import os, sys, json
import numpy as np
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=2")
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=2, process_id=int(sys.argv[2]))
from jax.sharding import Mesh
from fastk_tpu.parallel.multihost import count_files_multihost

paths = json.loads(sys.argv[3])
mesh = Mesh(np.array(jax.devices()), ("d",))
out = count_files_multihost(paths, 17, mesh=mesh, table_min=1,
                            batch_bases=3000)
res = dict(nreads=out.nreads, totlen=out.totlen,
           hist=np.asarray(out.hist.bins()).tolist()
           if hasattr(out.hist, "bins") else None,
           n=len(out.table),
           packed=out.table.packed.tobytes().hex(),
           counts=out.table.counts.tobytes().hex())
with open(sys.argv[4], "w") as f:
    json.dump(res, f)
"""


@pytest.mark.slow
def test_multihost_two_process_cpu(data, tmp_path):
    """Two REAL processes, 2 virtual CPU devices each, one global 4-device
    mesh over a localhost coordinator."""
    import json
    import socket

    from fastk_tpu.pipeline.count import count_files

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    outs = [str(tmp_path / f"out{i}.json") for i in range(2)]
    env = {**os.environ}
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    # the worker script lives in tmp_path, so the repo root is not on its
    # sys.path implicitly — pass it (works installed or from a checkout)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    def attempt():
        """One coordinated 2-process run; returns None on success, else a
        failure description. Fresh port per attempt (the coordinator does
        not always release its socket fast enough to rebind)."""
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        coord = f"127.0.0.1:{port}"
        procs = [subprocess.Popen(
            [sys.executable, str(worker), coord, str(i), json.dumps(data),
             outs[i]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)
            for i in range(2)]
        for p in procs:
            try:
                # two workers compile concurrently on (possibly) one core,
                # often while other suites hog it; budget generously — the
                # slow part is compilation, not the run
                p.wait(timeout=900)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.wait()
                return "multihost worker timed out"
        for p in procs:
            if p.returncode != 0:
                return "worker failed: " + p.stderr.read().decode()[-2000:]
        return None

    # compile storms and coordinator handshake races on a loaded 1-core box
    # are environmental, not product bugs: retry once before failing
    fail = attempt()
    if fail is not None:
        fail = attempt()
    if fail is not None:
        pytest.fail(fail)

    want = count_files(data, 17, table_min=1, batch_bases=3000)
    for o in outs:
        with open(o) as f:
            res = json.load(f)
        assert res["nreads"] == want.nreads
        assert res["totlen"] == want.totlen
        assert res["n"] == len(want.table)
        assert bytes.fromhex(res["packed"]) == want.table.packed.tobytes()
        assert bytes.fromhex(res["counts"]) == want.table.counts.tobytes()
