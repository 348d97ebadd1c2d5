"""Sharded device-resident serving (swtpu.bank.serving) on the 8-device
virtual CPU mesh: per-device resident stream shards + replicated query
register + collective top-K — the reference's per-module resident feeders
(ScoreBank_v2.v:77-139) at the MODULES axis."""

import jax
import numpy as np
import pytest

from swtpu.bank import ScoreBank
from swtpu.config import SWConfig
from swtpu.oracle import score_many_vs_one
from swtpu.parallel import make_mesh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (CPU virtual mesh)")
    return make_mesh(8)


@pytest.fixture(scope="module")
def bank():
    return ScoreBank(backend="stream", interpret=True)


def _targets(rng, n, lo=3, hi=40):
    return [rng.integers(0, 4, size=rng.integers(lo, hi)).astype(np.int8)
            for _ in range(n)]


def test_loaded_sharded_parity(mesh, bank):
    rng = np.random.default_rng(10)
    targets = _targets(rng, 37)
    db = bank.load_database_sharded(targets, mesh)
    assert db.n_shards == 8
    for qlen in (9, 100, 128):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        res = bank.score_loaded_sharded(query, db)
        np.testing.assert_array_equal(
            res.scores, score_many_vs_one(query, targets)
        )
        assert res.cells == qlen * sum(len(t) for t in targets)


def test_loaded_sharded_long_query_chained(mesh, bank):
    """Long queries chain tiles per shard (the chaining-port intent under
    shard_map); the resident layout serves any query length."""
    rng = np.random.default_rng(11)
    targets = _targets(rng, 19)
    db = bank.load_database_sharded(targets, mesh)
    for qlen in (64, 130, 300, 385):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        res = bank.score_loaded_sharded(query, db)
        np.testing.assert_array_equal(
            res.scores, score_many_vs_one(query, targets)
        )


def test_loaded_sharded_segmented_short_queries(mesh, bank):
    """The 32nt class over the mesh: a short query runs one short tile per
    shard, same as the single-device loader."""
    rng = np.random.default_rng(12)
    targets = _targets(rng, 23, lo=2, hi=25)
    db = bank.load_database_sharded(targets, mesh)
    query = rng.integers(0, 4, size=30).astype(np.int8)
    res = bank.score_loaded_sharded(query, db)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    longer = rng.integers(0, 4, size=40).astype(np.int8)
    res = bank.score_loaded_sharded(longer, db)
    np.testing.assert_array_equal(
        res.scores, score_many_vs_one(longer, targets)
    )


def test_topk_loaded_sharded_tie_consistency(mesh, bank):
    """The collective top-K off the resident database orders ties exactly
    like the host ScoreResult.top_k (score desc, id asc)."""
    rng = np.random.default_rng(13)
    base = [rng.integers(0, 4, size=rng.integers(6, 20)).astype(np.int8)
            for _ in range(3)]
    targets = [base[int(rng.integers(0, 3))] for _ in range(26)]
    query = rng.integers(0, 4, size=12).astype(np.int8)
    db = bank.load_database_sharded(targets, mesh)
    res = bank.score_loaded_sharded(query, db)
    k = 7
    got = bank.topk_loaded_sharded(query, db, k=k)
    assert got == res.top_k(k)
    # and against the single-chip loaded path
    db1 = bank.load_database(targets)
    assert got == bank.topk_loaded(query, db1, k=k)


def test_loaded_sharded_many_pipelined(mesh, bank):
    rng = np.random.default_rng(14)
    targets = _targets(rng, 17)
    db = bank.load_database_sharded(targets, mesh)
    queries = [rng.integers(0, 4, size=rng.integers(5, 100)).astype(np.int8)
               for _ in range(4)]
    results = bank.score_loaded_many_sharded(queries, db)
    for q, r in zip(queries, results):
        np.testing.assert_array_equal(r.scores, score_many_vs_one(q, targets))


def test_loaded_sharded_dense_form_and_events(mesh, bank, tmp_path):
    """The dense EncodedDB (mat, lens) form loads shard-sliced without
    per-read Python lists, and serving dispatches emit events."""
    from swtpu.utils import EventLog

    rng = np.random.default_rng(15)
    lens = rng.integers(4, 30, size=21).astype(np.int32)
    mat = np.zeros((21, 30), np.int8)
    for i, L in enumerate(lens):
        mat[i, :L] = rng.integers(0, 4, size=L)
    targets = [mat[i, : lens[i]] for i in range(21)]
    db = bank.load_database_sharded((mat, lens), mesh)
    query = rng.integers(0, 4, size=16).astype(np.int8)
    log = EventLog(tmp_path / "serve.jsonl")
    res = bank.score_loaded_sharded(query, db, event_log=log)
    bank.topk_loaded_sharded(query, db, k=3, event_log=log)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    kinds = [e.kind for e in log.events]
    assert kinds == ["loaded_sharded", "loaded_sharded_topk"]
    assert all(e.reads == 21 for e in log.events)


def test_loaded_sharded_fewer_reads_than_shards(mesh, bank):
    """n_reads < n_shards leaves some shards empty — results still exact."""
    rng = np.random.default_rng(16)
    targets = _targets(rng, 5)
    db = bank.load_database_sharded(targets, mesh)
    query = rng.integers(0, 4, size=11).astype(np.int8)
    res = bank.score_loaded_sharded(query, db)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))
    top = bank.topk_loaded_sharded(query, db, k=8)  # k > n_reads
    assert len(top) == 5  # sentinel slots filtered


def test_loaded_sharded_requires_stream_backend(mesh):
    scan_bank = ScoreBank(backend="scan")
    with pytest.raises(ValueError, match="stream backend"):
        scan_bank.load_database_sharded([np.zeros(4, np.int8)], mesh)


def test_loaded_sharded_biased_long_query(mesh):
    """score_width composes with sharded serving at any query length
    (biased chained tiles under shard_map)."""
    from swtpu.oracle import sw_score_single_biased

    rng = np.random.default_rng(17)
    W = 9
    wbank = ScoreBank(
        SWConfig(score_width=W), backend="stream", interpret=True
    )
    targets = _targets(rng, 13)
    db = wbank.load_database_sharded(targets, mesh)
    query = np.tile(np.arange(4, dtype=np.int8), 40)  # 160 nt, self-sim
    want = np.array(
        [sw_score_single_biased(query, t, score_width=W) for t in targets],
        np.int32,
    )
    res = wbank.score_loaded_sharded(query, db)
    np.testing.assert_array_equal(res.scores, want)
