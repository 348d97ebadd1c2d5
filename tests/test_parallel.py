"""Multi-chip sharding on the 8-device virtual CPU mesh (PSLSE-style
hardware-free harness): sharded scores == oracle, collective top-K merge."""

import jax
import numpy as np
import pytest

from swtpu.ops import sentinel_pad_batch
from swtpu.oracle import sw_score_batch
from swtpu.parallel import make_mesh, make_sharded_scorer, make_sharded_topk


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (CPU virtual mesh)")
    return make_mesh(8)


def _batch(rng, B, m, n):
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    ql = rng.integers(1, m + 1, size=B)
    tl = rng.integers(1, n + 1, size=B)
    return q, ql, t, tl


def test_sharded_scores_match_oracle(mesh):
    rng = np.random.default_rng(0)
    q, ql, t, tl = _batch(rng, 64, 32, 48)
    want = sw_score_batch(q, t, ql, tl)
    qp, tp = sentinel_pad_batch(q, ql, t, tl)
    scorer = make_sharded_scorer(mesh)
    got = np.asarray(scorer(qp, tp))
    np.testing.assert_array_equal(got, want)


def test_sharded_topk_merge(mesh):
    rng = np.random.default_rng(1)
    q, ql, t, tl = _batch(rng, 64, 32, 48)
    want = sw_score_batch(q, t, ql, tl)
    qp, tp = sentinel_pad_batch(q, ql, t, tl)
    ids = np.arange(64, dtype=np.int32)
    topk = make_sharded_topk(mesh, k=5)
    top_s, top_ids, scores = (np.asarray(x) for x in topk(qp, tp, ids))
    np.testing.assert_array_equal(scores, want)
    order = np.argsort(-want, kind="stable")
    np.testing.assert_array_equal(np.sort(top_s)[::-1], np.sort(want[order[:5]])[::-1])
    # every reported (score, id) pair must be genuine
    for s, i in zip(top_s, top_ids):
        assert want[i] == s


def test_sharded_pallas_interpret(mesh):
    # the dense scorer under shard_map in wrap-parity mode (the mode the
    # column kernel carried): W=12 on short reads is the identity regime
    rng = np.random.default_rng(2)
    q, ql, t, tl = _batch(rng, 16, 8, 8)
    want = sw_score_batch(q, t, ql, tl)
    qp, tp = sentinel_pad_batch(q, ql, t, tl)
    scorer = make_sharded_scorer(mesh, score_width=12)
    got = np.asarray(scorer(qp, tp))
    np.testing.assert_array_equal(got, want)


def test_multihost_api_single_process(mesh):
    # score_database_multihost works degenerate-single-process over the
    # virtual mesh (same code path real deployments use)
    from swtpu.oracle import score_many_vs_one
    from swtpu.parallel.multihost import score_database_multihost

    rng = np.random.default_rng(5)
    targets = [rng.integers(0, 4, size=rng.integers(4, 60)).astype(np.int8) for _ in range(24)]
    query = rng.integers(0, 4, size=16).astype(np.int8)
    want = score_many_vs_one(query, targets)
    top_s, top_ids, local = score_database_multihost(
        query, targets, np.arange(24, dtype=np.int32), mesh=mesh, k=4,
        backend="stream",
    )
    np.testing.assert_array_equal(local, want)
    for s, i in zip(top_s, top_ids):
        assert want[i] == s


def test_sharded_stream_scorer(mesh):
    # the headline wavefront kernel sharded over the mesh (interpret on CPU)
    from swtpu.bank.streams import pack_streams_sharded, scatter_sharded_scores
    from swtpu.oracle import score_many_vs_one
    from swtpu.parallel import make_sharded_stream_scorer

    rng = np.random.default_rng(6)
    targets = [
        rng.integers(0, 4, size=rng.integers(3, 50)).astype(np.int8)
        for _ in range(37)
    ]
    query = rng.integers(0, 4, size=21).astype(np.int8)
    want = score_many_vs_one(query, targets)
    batch = pack_streams_sharded(query, targets, n_shards=8, n_streams=8)
    scorer = make_sharded_stream_scorer(mesh, interpret=True)
    got = scatter_sharded_scores(
        np.asarray(
            scorer(
                batch.q, batch.stream, batch.emit_stream,
                batch.emit_step.astype(np.int32), batch.ids,
            )
        ),
        batch,
        len(targets),
    )
    np.testing.assert_array_equal(got, want)


def test_sharded_stream_topk(mesh):
    from swtpu.bank.streams import pack_streams_sharded, scatter_sharded_scores
    from swtpu.oracle import score_many_vs_one
    from swtpu.parallel import make_sharded_stream_scorer

    rng = np.random.default_rng(7)
    targets = [
        rng.integers(0, 4, size=rng.integers(3, 50)).astype(np.int8)
        for _ in range(29)
    ]
    query = rng.integers(0, 4, size=17).astype(np.int8)
    want = score_many_vs_one(query, targets)
    batch = pack_streams_sharded(query, targets, n_shards=8, n_streams=8)
    scorer = make_sharded_stream_scorer(mesh, interpret=True, k=5)
    s, top_s, top_ids = scorer(
        batch.q, batch.stream, batch.emit_stream,
        batch.emit_step.astype(np.int32), batch.ids,
    )
    got = scatter_sharded_scores(np.asarray(s), batch, len(targets))
    np.testing.assert_array_equal(got, want)
    top_s, top_ids = np.asarray(top_s), np.asarray(top_ids)
    order = np.argsort(-want, kind="stable")
    np.testing.assert_array_equal(np.sort(top_s), np.sort(want[order[:5]]))
    for s_, i in zip(top_s, top_ids):
        assert want[i] == s_


def test_sharded_stream_multirow():
    # 4-row tiles shard identically: a 20-row query chains 5 tiles per
    # shard
    import jax
    from swtpu.bank.streams import pack_streams_sharded, scatter_sharded_scores
    from swtpu.oracle import score_many_vs_one
    from swtpu.parallel import make_mesh, make_sharded_stream_scorer

    n_dev = len(jax.devices())
    rng = np.random.default_rng(42)
    targets = [
        rng.integers(0, 4, size=rng.integers(2, 30)).astype(np.int8)
        for _ in range(3 * n_dev + 1)
    ]
    query = rng.integers(0, 4, size=20).astype(np.int8)
    batch = pack_streams_sharded(
        query, targets, n_shards=n_dev, n_streams=8
    )
    mesh = make_mesh(n_dev)
    scorer = make_sharded_stream_scorer(mesh, interpret=True, tile=4, k=2)
    s, ts, tids = scorer(
        batch.q, batch.stream, batch.emit_stream,
        batch.emit_step.astype(np.int32), batch.ids,
    )
    got = scatter_sharded_scores(np.asarray(s), batch, len(targets))
    want = score_many_vs_one(query, targets)
    np.testing.assert_array_equal(got, want)
    assert int(np.asarray(ts)[0]) == want.max()


def test_topk_tie_consistency_with_host(mesh):
    """Round-4 (VERDICT weak #7): equal scores order identically in the
    host ScoreResult.top_k (stable argsort -> ascending id) and the
    collective merge, wherever the tied reads land on the mesh."""
    from swtpu.bank.scorebank import ScoreResult

    rng = np.random.default_rng(42)
    B, m, n = 32, 12, 16
    q1 = rng.integers(0, 4, size=m).astype(np.int8)
    t_base = rng.integers(0, 4, size=(4, n)).astype(np.int8)
    # every read duplicates one of 4 distinct targets -> massive score ties
    t = t_base[rng.integers(0, 4, size=B)]
    q = np.tile(q1[None, :], (B, 1))
    ids = np.arange(B, dtype=np.int32)
    k = 10
    topk = make_sharded_topk(mesh, k=k)
    top_s, top_ids, scores = topk(q, t, ids)
    host = ScoreResult(
        np.asarray(scores), 0, 0, 1.0
    ).top_k(k)
    got = list(zip(np.asarray(top_s).tolist(), np.asarray(top_ids).tolist()))
    assert got == host


def test_sharded_stream_topk_tie_consistency(mesh):
    from swtpu.bank.scorebank import ScoreResult
    from swtpu.bank.streams import pack_streams_sharded, scatter_sharded_scores
    from swtpu.parallel import make_sharded_stream_scorer

    rng = np.random.default_rng(43)
    base = [rng.integers(0, 4, size=rng.integers(6, 20)).astype(np.int8)
            for _ in range(3)]
    targets = [base[int(rng.integers(0, 3))] for _ in range(26)]
    query = rng.integers(0, 4, size=10).astype(np.int8)
    k = 8
    batch = pack_streams_sharded(query, targets, n_shards=8, n_streams=4)
    scorer = make_sharded_stream_scorer(mesh, interpret=True, k=k)
    s, ts, tids = scorer(
        batch.q, batch.stream, batch.emit_stream,
        batch.emit_step.astype(np.int32), batch.ids,
    )
    got_scores = scatter_sharded_scores(np.asarray(s), batch, len(targets))
    host = ScoreResult(got_scores, 0, 0, 1.0).top_k(k)
    got = list(zip(np.asarray(ts).tolist(), np.asarray(tids).tolist()))
    assert got == host


def test_local_topk_two_level_exact():
    """The two-level per-shard top-k (large-R path) is exact, including
    (score desc, id asc) tie preference, against a numpy reference —
    mesh-free, so it runs in the single-device suite too."""
    import jax.numpy as jnp

    from swtpu.parallel.sharded import _local_topk

    rng = np.random.default_rng(77)
    for R in (1280, 1290, 4096):  # incl. a non-multiple of 128
        # few distinct scores -> heavy ties straddling rows
        s = rng.integers(0, 7, size=R).astype(np.int32)
        ids = np.arange(R, dtype=np.int32)
        for kk in (1, 3, 10):
            fs, fids = _local_topk(jnp.asarray(s), jnp.asarray(ids), kk)
            order = np.lexsort((ids, -s))[:kk]
            np.testing.assert_array_equal(np.asarray(fs), s[order])
            np.testing.assert_array_equal(np.asarray(fids), ids[order])


def test_local_topk_large_r_collective(mesh):
    """R > 512 through the full collective merge on the 8-device mesh."""
    rng = np.random.default_rng(78)
    B, m, n = 8 * 1280, 8, 8
    q = np.tile(rng.integers(0, 4, size=(1, m)).astype(np.int8), (B, 1))
    t = np.tile(rng.integers(0, 4, size=(1, n)).astype(np.int8), (B, 1))
    ids = np.arange(B, dtype=np.int32)
    topk = make_sharded_topk(mesh, k=6)
    top_s, top_ids, scores = topk(q, t, ids)
    # every pair identical -> all scores tie; winners must be ids 0..5
    np.testing.assert_array_equal(np.asarray(top_ids), np.arange(6))


def test_multihost_api_long_query(mesh):
    """The stream-backed production API serves long queries (sharded
    chained tiles), matching the oracle."""
    from swtpu.oracle import score_many_vs_one
    from swtpu.parallel.multihost import score_database_multihost

    rng = np.random.default_rng(6)
    targets = [rng.integers(0, 4, size=rng.integers(4, 40)).astype(np.int8)
               for _ in range(16)]
    query = rng.integers(0, 4, size=200).astype(np.int8)
    want = score_many_vs_one(query, targets)
    top_s, top_ids, local = score_database_multihost(
        query, targets, np.arange(16, dtype=np.int32), mesh=mesh, k=3,
        backend="stream",
    )
    np.testing.assert_array_equal(local, want)
    for s, i in zip(top_s, top_ids):
        assert want[i] == s


def test_multihost_stream_steps_pinning(mesh):
    """stream_steps pins the packed stream length (the cross-host shape
    agreement knob for ragged workloads): scores unchanged, and an
    undersized pin fails loudly."""
    from swtpu.oracle import score_many_vs_one
    from swtpu.parallel.multihost import score_database_multihost

    rng = np.random.default_rng(7)
    targets = [rng.integers(0, 4, size=rng.integers(4, 40)).astype(np.int8)
               for _ in range(16)]
    query = rng.integers(0, 4, size=20).astype(np.int8)
    want = score_many_vs_one(query, targets)
    _, _, local = score_database_multihost(
        query, targets, np.arange(16, dtype=np.int32), mesh=mesh, k=3,
        stream_steps=512, backend="stream",
    )
    np.testing.assert_array_equal(local, want)
    with pytest.raises(ValueError, match="stream_steps"):
        score_database_multihost(
            query, targets, np.arange(16, dtype=np.int32), mesh=mesh, k=3,
            stream_steps=32, backend="stream",
        )


def test_multihost_dense_form(mesh):
    """The dense (mat, lens) / EncodedDB form flows through
    score_database_multihost end-to-end (native per-shard packing) on both
    the stream and scan backends, matching the per-read-list form."""
    from swtpu.oracle import score_many_vs_one
    from swtpu.parallel.multihost import score_database_multihost

    rng = np.random.default_rng(8)
    B, n = 24, 40
    lens = rng.integers(4, n + 1, size=B).astype(np.int32)
    mat = np.zeros((B, n), np.int8)
    for i in range(B):
        mat[i, : lens[i]] = rng.integers(0, 4, size=lens[i])
    targets = [mat[i, : lens[i]] for i in range(B)]
    query = rng.integers(0, 4, size=16).astype(np.int8)
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    for backend in ("stream", "scan"):
        top_s, top_ids, local = score_database_multihost(
            query, (mat, lens), ids, mesh=mesh, k=4, backend=backend,
        )
        np.testing.assert_array_equal(local, want)
        for s, i in zip(top_s, top_ids):
            assert want[i] == s


def test_multihost_stream_steps_chunk_validation(mesh):
    """A stream_steps pin that is not a STEP_CHUNK multiple fails up front
    with the contract named (round-4 advisor)."""
    from swtpu.parallel.multihost import score_database_multihost

    rng = np.random.default_rng(9)
    targets = [rng.integers(0, 4, size=10).astype(np.int8) for _ in range(8)]
    query = rng.integers(0, 4, size=8).astype(np.int8)
    with pytest.raises(ValueError, match="multiple of"):
        score_database_multihost(
            query, targets, np.arange(8, dtype=np.int32), mesh=mesh,
            stream_steps=100, backend="stream",
        )
