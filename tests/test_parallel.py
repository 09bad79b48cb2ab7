"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The invariant mirrors the reference's distributed contract: Fastmerge of
per-part runs equals a whole run (README.md:263-297) — here, an 8-chip
sharded count must equal the 1-chip count exactly.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import jax

from fastk_tpu.io.reader import read_file
from fastk_tpu.parallel.dist import make_mesh
from fastk_tpu.parallel.host import sharded_count, train_splitters

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def small_codes():
    return read_file(os.path.join(GOLDEN, "inputs", "small.fasta"))


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_sharded_equals_single(small_codes, ndev):
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    k = 40
    mesh1 = make_mesh(1)
    w1, c1, h1, o1, _ = sharded_count(small_codes.codes, k, mesh1)
    mesh = make_mesh(ndev)
    w, c, h, o, _ = sharded_count(small_codes.codes, k, mesh)
    assert np.array_equal(h, h1)
    assert o == o1
    assert np.array_equal(w, w1)
    assert np.array_equal(c, c1)


def test_sharded_matches_pipeline_hist(small_codes):
    """The sharded histogram equals the oracle-validated single-chip one."""
    from fastk_tpu.formats.hist import Histogram, read_histogram

    k = 40
    mesh = make_mesh(8)
    w, c, hist_arr, overflow, _ = sharded_count(small_codes.codes, k, mesh)
    got = Histogram.from_clipped_counts(
        k, np.minimum(c, 32767), int(np.maximum(c - 32767, 0).sum()))
    want = read_histogram(os.path.join(GOLDEN, "small_k40", "small"))
    assert got == want
    # the device histogram agrees too
    assert np.array_equal(hist_arr[1:], want.counts)


def test_sharded_positions(small_codes):
    """Profile counts returned through the inverse all_to_all match the
    single-chip position counts."""
    k = 40
    mesh1 = make_mesh(1)
    _, _, _, _, p1 = sharded_count(small_codes.codes, k, mesh1,
                                   want_positions=True)
    mesh = make_mesh(8)
    _, _, _, _, p8 = sharded_count(small_codes.codes, k, mesh,
                                   want_positions=True)
    assert np.array_equal(p1, p8)


def test_trained_splitters_balance(small_codes):
    mesh = make_mesh(8)
    spl = train_splitters(small_codes.codes, 40, mesh)
    assert len(spl) == 7
    assert (np.diff(spl.astype(np.int64)) > 0).all()


def test_count_files_sharded_matches_pipeline(tmp_path):
    """Pipeline-level multi-chip counting equals the single-chip pipeline."""
    import numpy as np

    from fastk_tpu.parallel.dist import make_mesh
    from fastk_tpu.parallel.host import count_files_sharded
    from fastk_tpu.pipeline.count import count_files

    rng = np.random.default_rng(3)
    p = str(tmp_path / "in.fasta")
    with open(p, "w") as f:
        for i in range(50):
            s = "".join("acgt"[c] for c in rng.integers(0, 4, size=150))
            f.write(f">r{i}\n{s}\n")

    a = count_files([p], 17, table_min=1, batch_bases=3000)
    b = count_files_sharded([p], 17, make_mesh(4), table_min=1,
                            batch_bases=3000)
    assert a.hist == b.hist
    assert np.array_equal(a.table.packed, b.table.packed)
    assert np.array_equal(a.table.counts, b.table.counts)


def test_count_files_sharded_profiles(tmp_path):
    """Multi-chip profiles equal the single-chip pipeline's, in both the
    single-batch (inverse all_to_all) and multi-batch (join) regimes."""
    import numpy as np

    from fastk_tpu.parallel.dist import make_mesh
    from fastk_tpu.parallel.host import count_files_sharded
    from fastk_tpu.pipeline.count import count_files

    rng = np.random.default_rng(9)
    p = str(tmp_path / "in.fasta")
    with open(p, "w") as f:
        for i in range(30):
            s = "".join("acgt"[c] for c in rng.integers(0, 4, size=120))
            f.write(f">r{i}\n{s}\n")

    for bb in (10_000_000, 1500):  # one batch / several batches
        a = count_files([p], 15, profiles=True, batch_bases=bb)
        b = count_files_sharded([p], 15, make_mesh(4), profiles=True,
                                batch_bases=bb)
        assert a.hist == b.hist
        assert len(a.profiles) == len(b.profiles)
        for x, y in zip(a.profiles, b.profiles):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("cap_frac", [1.6, 0.2])
def test_route_merge_impl_matches_scatter(cap_frac):
    """The routing step's placement (one scatter into [ndev, cap] send
    lanes) against a numpy placement: each lane holds exactly the valid
    records routed to that chip, up to its capacity, and the overflow
    counts the rest. Order within a lane follows an unstable sort, so
    lanes compare as sorted row sets."""
    import jax.numpy as jnp
    import numpy as np

    from fastk_tpu.ops.kmers import canonical_kmers, pad_needed
    from fastk_tpu.parallel.dist import _route_chip

    k, size, ndev = 13, 4096, 4
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size + pad_needed(k)).astype(np.uint8)
    codes[::211] = 4
    words, invalid = canonical_kmers(jnp.asarray(codes), k, size)
    spl = np.array([1 << 29, 1 << 30, 3 << 29], np.uint32)
    cap = int(size // ndev * cap_frac)
    pos = jnp.arange(size, dtype=jnp.uint32)
    sw, sv, ovf, orig, flat, sp = _route_chip(
        words, invalid, pos, jnp.asarray(spl), ndev, cap, size,
        carry_pos=True)

    w = np.stack([np.asarray(x) for x in words], axis=1)
    ok = np.asarray(invalid) == 0
    dest = np.searchsorted(spl, w[:, 0], side="right")
    lanes_w = np.stack([np.asarray(x) for x in sw], axis=2)  # [ndev,cap,W]
    lanes_p, lanes_v = np.asarray(sp), np.asarray(sv)
    want_ovf = 0
    for d in range(ndev):
        mine = ok & (dest == d)
        n = int(mine.sum())
        want_ovf += max(0, n - cap)
        got_n = int((lanes_v[d] > 0).sum())
        assert got_n == min(n, cap)
        assert (lanes_v[d, :got_n] == 1).all()
        assert (lanes_v[d, got_n:] == 0).all()
        assert (lanes_w[d, got_n:] == 0).all()
        assert (lanes_p[d, got_n:] == 0).all()
        got = np.concatenate([lanes_w[d, :got_n],
                              lanes_p[d, :got_n, None]], axis=1)
        exp = np.concatenate([w[mine], np.flatnonzero(mine)[:, None]],
                             axis=1).astype(np.uint32)
        rows = {tuple(r) for r in exp}
        assert all(tuple(r) in rows for r in got)  # placed records are real
        if n <= cap:
            assert np.array_equal(np.unique(got, axis=0),
                                  np.unique(exp, axis=0))
    assert int(ovf) == want_ovf
    # (orig, flat) locate each placed record's send slot
    fl, og = np.asarray(flat), np.asarray(orig)
    placed = fl < ndev * cap
    assert np.array_equal(lanes_p.reshape(-1)[fl[placed]], og[placed])


def test_relative_profiles_sharded(tmp_path):
    """Multi-chip -p:<table> equals the single-chip relative path: profiles
    of reads B against the table of reads A, on a 4-chip mesh, in both the
    one-batch and several-batch regimes."""
    import numpy as np

    from fastk_tpu.parallel.dist import make_mesh
    from fastk_tpu.parallel.host import relative_profiles_sharded
    from fastk_tpu.pipeline.count import count_files

    rng = np.random.default_rng(11)
    pa = str(tmp_path / "a.fasta")
    pb = str(tmp_path / "b.fasta")
    ref = "".join("acgt"[c] for c in rng.integers(0, 4, size=600))
    with open(pa, "w") as f:
        for i in range(20):
            o = rng.integers(0, 400)
            f.write(f">a{i}\n{ref[o:o + 200]}\n")
    with open(pb, "w") as f:
        for i in range(25):
            o = rng.integers(0, 450)
            s = list(ref[o:o + 150])
            if i % 3 == 0:           # some novel k-mers (absent -> 0)
                s[50] = "acgt"[(rng.integers(1, 4) + "acgt".index(s[50])) % 4]
            if i == 7:               # an N run
                s[80:85] = "n" * 5
            f.write(f">b{i}\n{''.join(s)}\n")

    tab = count_files([pa], 13, table_min=1).table
    single = count_files([pb], 13, profiles=True, relative_table=tab)
    for bb in (10_000_000, 1200):
        multi = relative_profiles_sharded([pb], tab, make_mesh(4),
                                          batch_bases=bb)
        assert len(multi.profiles) == len(single.profiles) == 25
        for x, y in zip(single.profiles, multi.profiles):
            assert np.array_equal(x, y)


def test_route_overflow_auto_rebalance():
    """A composition shift between the splitter-training sample and a later
    batch (random -> GC-poor) must retrain splitters and complete, matching
    the single-chip result, instead of raising on route overflow."""
    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")
    k = 24
    rng = np.random.default_rng(11)
    # train on uniform composition...
    train = rng.integers(0, 4, 4096).astype(np.uint8)
    # ...then count a stream whose k-mers crowd the low keyspace (mostly
    # A/C), so uniform splitters route nearly everything to few chips
    skew = rng.choice(np.array([0, 1], np.uint8), 16384, p=[0.8, 0.2])
    codes = np.concatenate([skew, np.full(64, 4, np.uint8)])

    mesh = make_mesh(8)
    splitters = train_splitters(train, k, mesh)
    with pytest.raises(RuntimeError):
        sharded_count(codes, k, mesh, splitters=splitters, slack=1.05,
                      auto_rebalance=False)
    reb = {}
    w, c, h, o, _ = sharded_count(codes, k, mesh, splitters=splitters,
                                  slack=1.05, rebalance_state=reb)
    assert "splitters" in reb  # retrain happened and is carried forward
    w1, c1, h1, o1, _ = sharded_count(codes, k, make_mesh(1))
    assert np.array_equal(w, w1) and np.array_equal(c, c1)
    assert np.array_equal(h, h1) and o == o1
