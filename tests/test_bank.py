"""ScoreBank pipeline: bucketing, packing, ID pairing, end-to-end parity."""

import numpy as np
import pytest

from swtpu.bank import ScoreBank, pack_many_vs_one, plan_buckets
from swtpu.config import SWConfig
from swtpu.io import encode_seq, read_fasta, read_query_and_db
from swtpu.oracle import score_many_vs_one
from swtpu.testing import (
    REFERENCE_DATA_DIR,
    parse_rtl_out_file,
    reference_data_available,
)


def test_bucket_plan_smallest_fit():
    plan = plan_buckets([10, 32, 33, 128, 500], (32, 128, 512))
    np.testing.assert_array_equal(plan.assignments, [0, 0, 1, 1, 2])
    assert 0 < plan.fill[0] <= 1.0


def test_bucket_overflow_raises():
    with pytest.raises(ValueError):
        plan_buckets([600], (32, 128, 512))


def test_pack_ids_roundtrip():
    rng = np.random.default_rng(0)
    targets = [rng.integers(0, 4, size=L).astype(np.int8) for L in [10, 40, 100, 12, 80]]
    query = rng.integers(0, 4, size=16).astype(np.int8)
    batches = pack_many_vs_one(query, targets, bucket_lens=(32, 128), batch_align=4)
    seen = set()
    for b in batches:
        for k, rid in enumerate(b.ids):
            if rid < 0:
                assert b.t_lens[k] == 0
                continue
            seen.add(int(rid))
            # packed row must reproduce the original read
            np.testing.assert_array_equal(b.t[k, : b.t_lens[k]], targets[rid])
    assert seen == set(range(len(targets)))


def test_auto_backend_follows_platform_table(monkeypatch):
    # auto follows the platform table: the wavefront kernel, compiled, on
    # the GPU (the reference's bank instantiates its fastest array,
    # ScoreBank_v2.v:117); the scan, with an interpreted kernel, on the CPU;
    # a platform without a row is refused, never a silent fallback
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    bank = ScoreBank(backend="auto")
    assert bank.backend == "stream" and bank.plan.interpret is False
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    bank = ScoreBank(backend="auto")
    assert bank.backend == "scan" and bank.plan.interpret is True
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(ValueError, match="no scoring kernel"):
        ScoreBank(backend="auto")


def test_scorebank_random_ragged():
    rng = np.random.default_rng(1)
    targets = [
        rng.integers(0, 4, size=rng.integers(5, 200)).astype(np.int8)
        for _ in range(37)
    ]
    query = rng.integers(0, 4, size=31).astype(np.int8)
    want = score_many_vs_one(query, targets)
    bank = ScoreBank(SWConfig(target_buckets=(32, 128, 256)), backend="scan")
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == sum(31 * len(t) for t in targets)
    assert res.padded_cells >= res.cells


@pytest.mark.skipif(not reference_data_available(), reason="no reference data")
def test_scorebank_golden_end_to_end():
    """Full pipeline (FASTA -> encode -> bucket -> pack -> kernel -> IDs)
    against the RTL golden for data1/query1 — the reference's minimum
    end-to-end slice (SURVEY.md §7)."""
    qrec = read_fasta(REFERENCE_DATA_DIR / "query1.fa")[0]
    _, db = read_query_and_db(REFERENCE_DATA_DIR / "data1.fa")
    query = encode_seq(qrec.seq)
    targets = [encode_seq(r.seq) for r in db]
    bank = ScoreBank(backend="scan")
    res = bank.score_database(query, targets)
    golden = parse_rtl_out_file(REFERENCE_DATA_DIR / "data1.fa_query1.fa_out.txt")
    for k, r in enumerate(db):
        if r.name in golden:
            assert int(res.scores[k]) == golden[r.name], r.name
    # the known first scores from the golden file (BASELINE.md)
    assert list(res.scores[:3]) == [133, 106, 135]
    # top-K reporting (the reference's unfinished max/vld_max intent)
    top = res.top_k(3)
    assert top[0][0] == max(golden.values())


def test_score_pairs_many_vs_many():
    rng = np.random.default_rng(9)
    n = 23
    queries = [rng.integers(0, 4, size=rng.integers(4, 120)).astype(np.int8) for _ in range(n)]
    targets = [rng.integers(0, 4, size=rng.integers(4, 250)).astype(np.int8) for _ in range(n)]
    from swtpu.oracle import sw_score_single

    want = np.array([sw_score_single(q, t) for q, t in zip(queries, targets)], np.int32)
    bank = ScoreBank(SWConfig(target_buckets=(32, 128, 256)), backend="scan")
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)


def test_score_pairs_stream_backend():
    # many-vs-many on the wavefront: distinct queries in per-stream query
    # registers (the reference's per-module ld_q, ScoreBank_v2.v:99-102)
    rng = np.random.default_rng(10)
    n = 30
    qpool = [rng.integers(0, 4, size=rng.integers(4, 110)).astype(np.int8) for _ in range(6)]
    queries = [qpool[int(rng.integers(0, 6))] for _ in range(n)]
    targets = [rng.integers(0, 4, size=rng.integers(2, 90)).astype(np.int8) for _ in range(n)]
    targets[5] = np.zeros((0,), np.int8)  # empty target scores 0
    from swtpu.oracle import sw_score_single

    want = np.array(
        [sw_score_single(q, t) for q, t in zip(queries, targets)], np.int32
    )
    bank = ScoreBank(backend="stream", interpret=True)
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == sum(len(q) * len(t) for q, t in zip(queries, targets))


def test_score_pairs_stream_short_queries_segmented():
    # the <= 32-base pair set that once packed four queries per column:
    # per-stream queries in one short tile
    rng = np.random.default_rng(12)
    n = 17
    queries = [rng.integers(0, 4, size=rng.integers(3, 30)).astype(np.int8) for _ in range(n)]
    targets = [rng.integers(0, 4, size=rng.integers(2, 60)).astype(np.int8) for _ in range(n)]
    from swtpu.oracle import sw_score_single

    want = np.array(
        [sw_score_single(q, t) for q, t in zip(queries, targets)], np.int32
    )
    bank = ScoreBank(backend="stream", interpret=True)
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)


def test_score_pairs_stream_chunks_many_distinct_queries():
    # 20 distinct >64-base queries on 8 interpret streams -> 3 invocations
    rng = np.random.default_rng(14)
    n = 20
    queries = [rng.integers(0, 4, size=rng.integers(70, 120)).astype(np.int8) for _ in range(n)]
    targets = [rng.integers(0, 4, size=rng.integers(2, 50)).astype(np.int8) for _ in range(n)]
    from swtpu.oracle import sw_score_single

    want = np.array(
        [sw_score_single(q, t) for q, t in zip(queries, targets)], np.int32
    )
    bank = ScoreBank(backend="stream", interpret=True)
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)


def test_dedupe_queries_shared_keying():
    # the single content-keyed dedup used by both the pair packer and the
    # ScoreBank chunker: same content -> same uid regardless of dtype or
    # container, so the chunk bound and the packer's U always agree
    from swtpu.bank.streams import dedupe_queries

    a = np.array([0, 1, 2, 3], np.int8)
    qs = [a, a.astype(np.int64), list(a), np.array([3, 2, 1, 0], np.int8)]
    qlist, uid = dedupe_queries(qs)
    assert len(qlist) == 2
    np.testing.assert_array_equal(uid, [0, 0, 0, 1])
    assert all(q.dtype == np.int8 for q in qlist)


def test_pack_pair_streams_chunking_limit():
    # more distinct queries than logical streams raises (ScoreBank chunks)
    from swtpu.bank.streams import pack_pair_streams

    rng = np.random.default_rng(13)
    queries = [rng.integers(0, 4, size=8 + i % 3).astype(np.int8) for i in range(9)]
    targets = [rng.integers(0, 4, size=12).astype(np.int8) for _ in range(9)]
    with pytest.raises(ValueError, match="distinct queries"):
        pack_pair_streams(queries, targets, n_streams=4)


def test_score_pairs_stream_mixed_long_queries():
    """A pair set mixing short and long queries stays on the wavefront:
    every stream holds its own query, padded to the longest, and long
    queries chain query tiles (no silent column-path downgrade)."""
    rng = np.random.default_rng(15)
    n = 18
    q_long_a = rng.integers(0, 4, size=500).astype(np.int8)
    q_long_b = rng.integers(0, 4, size=200).astype(np.int8)
    queries = []
    for i in range(n):
        if i % 3 == 0:
            queries.append(q_long_a)
        elif i % 3 == 1:
            queries.append(rng.integers(0, 4, size=64).astype(np.int8))
        else:
            queries.append(q_long_b)
    targets = [
        rng.integers(0, 4, size=rng.integers(2, 70)).astype(np.int8)
        for _ in range(n)
    ]
    from swtpu.oracle import sw_score_single

    want = np.array(
        [sw_score_single(q, t) for q, t in zip(queries, targets)], np.int32
    )
    bank = ScoreBank(backend="stream", interpret=True)
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == sum(len(q) * len(t) for q, t in zip(queries, targets))


def test_score_pairs_stream_all_long_queries():
    rng = np.random.default_rng(16)
    q_long = rng.integers(0, 4, size=300).astype(np.int8)
    queries = [q_long] * 5
    targets = [
        rng.integers(0, 4, size=rng.integers(5, 60)).astype(np.int8)
        for _ in range(5)
    ]
    from swtpu.oracle import sw_score_single

    want = np.array(
        [sw_score_single(q, t) for q, t in zip(queries, targets)], np.int32
    )
    bank = ScoreBank(backend="stream", interpret=True)
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)


def test_stream_chunked_pipeline_parity():
    """Round-4 (VERDICT #2): the pipelined chunked stream path is
    bit-identical to the monolithic dispatch, for ragged lists and dense
    databases, across chunk boundaries and the padded final chunk."""
    rng = np.random.default_rng(20)
    targets = [
        rng.integers(0, 4, size=rng.integers(2, 70)).astype(np.int8)
        for _ in range(29)
    ]
    query = rng.integers(0, 4, size=50).astype(np.int8)
    want = score_many_vs_one(query, targets)
    bank = ScoreBank(
        SWConfig(stream_chunk_reads=8), backend="stream", interpret=True
    )
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == sum(len(query) * len(t) for t in targets)

    # dense form through the same chunker
    w = max(len(t) for t in targets)
    mat = np.zeros((len(targets), w), np.int8)
    lens = np.zeros(len(targets), np.int32)
    for i, t in enumerate(targets):
        mat[i, : len(t)] = t
        lens[i] = len(t)
    res2 = bank.score_database(query, (mat, lens))
    np.testing.assert_array_equal(res2.scores, want)


def test_loaded_database_multi_query():
    """Device-resident database — pack once, serve many queries (only the
    query crosses the link per job), incl. chained long queries: the
    stream layout does not depend on the query, so any length serves."""
    rng = np.random.default_rng(21)
    targets = [
        rng.integers(0, 4, size=rng.integers(2, 70)).astype(np.int8)
        for _ in range(23)
    ]
    targets[4] = np.zeros((0,), np.int8)  # zero-length read scores 0
    bank = ScoreBank(backend="stream", interpret=True)
    db = bank.load_database(targets)
    # two long queries in a row exercise repeated chained dispatch on
    # the resident [T, N] stream (no per-call relayout)
    for qlen in (16, 100, 290, 260, 400):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        want = score_many_vs_one(query, targets)
        res = bank.score_loaded(query, db)
        np.testing.assert_array_equal(res.scores, want)
        assert res.cells == qlen * sum(len(t) for t in targets)
    # wrong backend is rejected up front
    with pytest.raises(ValueError, match="stream backend"):
        ScoreBank(backend="scan").load_database(targets)


def test_loaded_database_dense_form_and_guards():
    rng = np.random.default_rng(22)
    mat = rng.integers(0, 4, size=(17, 50)).astype(np.int8)
    lens = rng.integers(3, 51, size=17).astype(np.int32)
    targets = [mat[i, : lens[i]] for i in range(17)]
    bank = ScoreBank(backend="stream", interpret=True, verify_integrity=True)
    db = bank.load_database((mat, lens))
    query = rng.integers(0, 4, size=40).astype(np.int8)
    res = bank.score_loaded(query, db)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))


def test_loaded_database_many_and_topk():
    rng = np.random.default_rng(23)
    targets = [
        rng.integers(0, 4, size=rng.integers(5, 60)).astype(np.int8)
        for _ in range(19)
    ]
    bank = ScoreBank(backend="stream", interpret=True)
    db = bank.load_database(targets)
    queries = [rng.integers(0, 4, size=L).astype(np.int8) for L in (16, 64, 100)]
    results = bank.score_loaded_many(queries, db)
    for q, res in zip(queries, results):
        np.testing.assert_array_equal(res.scores, score_many_vs_one(q, targets))
    # on-device top-K matches the host ScoreResult.top_k, ties included
    want = results[1].top_k(5)
    got = bank.topk_loaded(queries[1], db, k=5)
    assert got == want


def test_loaded_database_segmented_short_queries():
    """The 32nt class on a resident database: a short query runs one short
    tile (the occupancy segments once bought), and the padded-cell count
    covers only that tile's rows."""
    rng = np.random.default_rng(24)
    targets = [
        rng.integers(0, 4, size=rng.integers(4, 50)).astype(np.int8)
        for _ in range(15)
    ]
    bank = ScoreBank(backend="stream", interpret=True)
    db = bank.load_database(targets)
    T, N = db.stream.shape
    for qlen in (8, 30, 50):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        res = bank.score_loaded(query, db)
        np.testing.assert_array_equal(
            res.scores, score_many_vs_one(query, targets)
        )
        K = -(-qlen // bank.plan.tile)
        assert res.padded_cells == T * N * K * -(-qlen // K)
