"""SCORE_WIDTH wrap-parity: the scan's and the stream kernel's
`score_width` mode vs the biased oracle (component #30, SURVEY.md §0).

The RTL carries every score in a SCORE_WIDTH-bit unsigned register biased by
ZERO = 2**(SCORE_WIDTH-1) (SW_ProcessingElement_v1.0.v:15-20): adds wrap
modulo 2**W, max is the unsigned compare, and the clamp-at-zero is the
sign-bit test on M_score.  A score crossing 2**(W-1)-1 therefore wraps and
is clamped back to zero in that cell.  `sw_score_single_biased` is the
sequential contract for those semantics; `score_width=W` reproduces them
vectorized (32-bit lanes carrying W-bit biased values — there is no 12-bit
datapath, so the register *width* is emulated, not stored).
"""

import numpy as np
import pytest

from swtpu.ops import sentinel_pad_batch
from swtpu.ops.scan import sw_scores_scan
from swtpu.oracle import (
    biased_view,
    sw_score_batch,
    sw_score_single,
    sw_score_single_biased,
)


def _biased_batch(qs, q_lens, ts, t_lens, score_width):
    return np.array(
        [
            sw_score_single_biased(
                qs[i, : q_lens[i]], ts[i, : t_lens[i]], score_width=score_width
            )
            for i in range(len(q_lens))
        ],
        dtype=np.int32,
    )


def test_biased_oracle_in_range_is_exact():
    # While scores fit the 12-bit window, biased arithmetic is the identity:
    # biased == exact == biased_view(exact).  This equivalence is why the
    # int32 kernels are bit-compatible with the 12-bit hardware.
    rng = np.random.default_rng(0)
    for _ in range(6):
        q = rng.integers(0, 4, size=rng.integers(4, 40)).astype(np.int8)
        t = rng.integers(0, 4, size=rng.integers(4, 40)).astype(np.int8)
        exact = sw_score_single(q, t)
        got = sw_score_single_biased(q, t, score_width=12)
        assert got == exact
        assert got == int(biased_view(np.array([exact]))[0])


def test_biased_oracle_wraps_on_overflow():
    # An identical 128-base pair scores 640 exactly — past a 10-bit
    # register's +511 ceiling.  The hardware wraps M past the top, loses the
    # sign bit, and clamps to zero; the running high score keeps the last
    # in-range value of the climb, not the true 640.
    seq = np.tile(np.arange(4, dtype=np.int8), 32)  # 128 bases
    exact = sw_score_single(seq, seq)
    assert exact == 640
    got = sw_score_single_biased(seq, seq, score_width=10)
    assert got < exact
    # climb by +5 from 0 wraps after floor((1023-512)/5)=102 matches: best
    # in-range value is 510
    assert got == 510


@pytest.mark.parametrize("score_width", [12, 10])
def test_biased_kernel_matches_oracle(score_width):
    rng = np.random.default_rng(1)
    B, m, n = 8, 32, 32
    q_lens = rng.integers(1, m + 1, size=B)
    t_lens = rng.integers(1, n + 1, size=B)
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    want = _biased_batch(q, q_lens, t, t_lens, score_width)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp, score_width=score_width))
    np.testing.assert_array_equal(got, want)


def test_biased_kernel_overflow_wrap():
    # Mixed batch: an overflowing identical pair next to in-range randoms —
    # the kernel must reproduce the per-cell wrap+clamp, not the exact score
    # and not biased_view of the exact score.
    rng = np.random.default_rng(2)
    m = n = 128
    B = 4
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    q[0] = t[0] = np.tile(np.arange(4, dtype=np.int8), 32)
    lens = np.full((B,), m)
    want = _biased_batch(q, lens, t, lens, 10)
    exact = sw_score_batch(q, t, lens, lens)
    assert want[0] != exact[0]  # the overflow case genuinely wraps
    qp, tp = sentinel_pad_batch(q, lens, t, lens)
    got = np.asarray(sw_scores_scan(qp, tp, score_width=10))
    np.testing.assert_array_equal(got, want)


def test_biased_kernel_in_range_equals_exact():
    # w=12 on ordinary data: the biased mode must agree with the exact
    # kernel bit-for-bit (the identity regime).
    rng = np.random.default_rng(3)
    B, m, n = 6, 24, 48
    q_lens = rng.integers(1, m + 1, size=B)
    t_lens = rng.integers(1, n + 1, size=B)
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    want = sw_score_batch(q, t, q_lens, t_lens)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp, score_width=12))
    np.testing.assert_array_equal(got, want)


def test_scorebank_score_width_routes_biased():
    # SWConfig.score_width selects wrap-parity for the whole bank path
    # (CLI: `swtpu score --score-width N`), mirroring main_test.c's biased
    # `result - 2048` reporting surface.  auto resolves through the
    # platform table: the stream kernel on the GPU, the scan on the CPU —
    # both implement the identical contract.
    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig
    from swtpu.device import kernel_plan

    rng = np.random.default_rng(5)
    query = np.tile(np.arange(4, dtype=np.int8), 10)  # 40 bases, scores 200
    targets = [rng.integers(0, 4, size=rng.integers(8, 32)).astype(np.int8)
               for _ in range(6)]
    targets.append(query.copy())  # exact self-match: 200 > an 8-bit ceiling
    bank = ScoreBank(SWConfig(score_width=8, target_buckets=(40,)))
    assert bank.backend == kernel_plan().backend
    got = bank.score_database(query, targets).scores
    want = np.array(
        [sw_score_single_biased(query, t, score_width=8) for t in targets],
        dtype=np.int32,
    )
    np.testing.assert_array_equal(got, want)
    exact = sw_score_single(query, query)
    assert exact == 200 and got[-1] < exact  # wrapped, not the exact score


@pytest.mark.slow
def test_biased_chained_long_query():
    # a 300-base query in wrap mode: an identical 300-base pair scores 1500
    # exactly — past the 10-bit ceiling.
    m = 300
    seq = np.tile(np.arange(4, dtype=np.int8), 75)
    rng = np.random.default_rng(4)
    B = 2
    q = np.stack([seq, rng.integers(0, 4, size=m).astype(np.int8)])
    t = np.stack([seq, rng.integers(0, 4, size=m).astype(np.int8)])
    lens = np.full((B,), m)
    want = _biased_batch(q, lens, t, lens, 10)
    assert want[0] < 1500
    qp, tp = sentinel_pad_batch(q, lens, t, lens)
    got = np.asarray(sw_scores_scan(qp, tp, score_width=10))
    np.testing.assert_array_equal(got, want)


# -------------- wrap-parity on the stream kernel ---------------------------


def _stream_biased_workload(rng, qlen=40):
    query = rng.integers(0, 4, size=qlen).astype(np.int8)
    targets = [
        rng.integers(0, 4, size=int(rng.integers(5, 60))).astype(np.int8)
        for _ in range(12)
    ]
    # high-identity reads force scores past small-W ceilings (wrap regime)
    for k in (10, 20, 30, qlen):
        targets.append(query[:k].copy())
    return query, targets


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_stream_kernel_biased_matches_oracle(rows):
    # `rows`-row tiles: 40 query rows as 40, 20 or 10 chained tiles
    from swtpu.bank.streams import pack_streams
    from swtpu.oracle import sw_score_single_biased
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(rows)
    W = 7
    query, targets = _stream_biased_workload(rng)
    want = np.array(
        [sw_score_single_biased(query, t, score_width=W) for t in targets],
        np.int32,
    )
    b = pack_streams(query, targets, n_streams=4)
    got = np.asarray(
        sw_scores_stream(
            b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
            interpret=True, tile=rows, score_width=W,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_stream_kernel_biased_segmented():
    # the 30-base case that once packed four queries per column
    from swtpu.bank.streams import pack_streams
    from swtpu.oracle import sw_score_single_biased
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(9)
    W = 7
    query, targets = _stream_biased_workload(rng, qlen=30)
    want = np.array(
        [sw_score_single_biased(query, t, score_width=W) for t in targets],
        np.int32,
    )
    b = pack_streams(query, targets, n_streams=8)
    got = np.asarray(
        sw_scores_stream(
            b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
            interpret=True, score_width=W,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_stream_kernel_biased_rejects_f32():
    # widths the wrap proof cannot carry are refused up front: past the
    # 32-bit lane, and too narrow for the penalties
    from swtpu.bank.streams import pack_streams
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(10)
    query, targets = _stream_biased_workload(rng)
    b = pack_streams(query, targets, n_streams=4)
    args = (b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32))
    with pytest.raises(ValueError, match="out of range"):
        sw_scores_stream(*args, interpret=True, score_width=31)
    with pytest.raises(ValueError, match="too narrow"):
        sw_scores_stream(*args, interpret=True, score_width=5)


def test_scorebank_stream_backend_score_width():
    """ScoreBank(backend='stream', score_width=W) scores the whole database
    through the biased wavefront, bit-exact vs the contract oracle —
    --score-width no longer costs the stream kernel's speed."""
    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig
    from swtpu.oracle import sw_score_single_biased

    rng = np.random.default_rng(11)
    W = 7
    query, targets = _stream_biased_workload(rng)
    want = np.array(
        [sw_score_single_biased(query, t, score_width=W) for t in targets],
        np.int32,
    )
    bank = ScoreBank(
        SWConfig(score_width=W), backend="stream", interpret=True
    )
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, want)
    # pairs ride the biased wavefront too
    res2 = bank.score_pairs([query] * len(targets), targets)
    np.testing.assert_array_equal(res2.scores, want)


def test_scorebank_stream_biased_long_pairs_keep_wrap():
    """score_width + a long query in score_pairs must keep wrap semantics:
    the chained stream tiles carry biased boundary strips
    (SW_ProcessingElement_v1.0.v:15-20 composed with the chaining ports,
    ScoringModule_v1.1.v:36-54), so mixed pair sets stay on the wavefront
    at full wrap parity."""
    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig
    from swtpu.oracle import sw_score_single_biased

    rng = np.random.default_rng(12)
    W = 10
    qlong = np.tile(np.arange(4, dtype=np.int8), 50)  # 200 nt
    qshort = rng.integers(0, 4, size=40).astype(np.int8)
    queries = [qlong, qshort, qlong]
    targets = [qlong.copy(),  # identical 200nt pair: exact 1000 > 511 wraps
               rng.integers(0, 4, size=30).astype(np.int8),
               rng.integers(0, 4, size=60).astype(np.int8)]
    want = np.array(
        [sw_score_single_biased(q, t, score_width=W)
         for q, t in zip(queries, targets)], np.int32,
    )
    assert want[0] != 1000  # the wrap actually fires
    bank = ScoreBank(
        SWConfig(score_width=W, target_buckets=(64, 256)),
        backend="stream", interpret=True,
    )
    res = bank.score_pairs(queries, targets)
    np.testing.assert_array_equal(res.scores, want)


def test_stream_long_kernel_biased_matches_oracle():
    """The chained tiles in wrap mode, directly: inter-tile D/G strips
    carry biased values; parity vs the contract oracle incl. a pair whose
    exact score crosses the W-bit ceiling (wrap fires)."""
    from swtpu.bank.streams import pack_streams
    from swtpu.oracle import sw_score_single_biased
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(20)
    W = 10
    query = np.tile(np.arange(4, dtype=np.int8), 75)  # 300 nt
    targets = [query.copy()]  # identical: exact 1500 > 511 -> wraps
    targets += [rng.integers(0, 4, size=int(rng.integers(5, 80))).astype(np.int8)
                for _ in range(6)]
    targets += [query[:200].copy(), query[:50].copy()]
    want = np.array(
        [sw_score_single_biased(query, t, score_width=W) for t in targets],
        np.int32,
    )
    assert want[0] < 1500  # the wrap actually fires
    b = pack_streams(query, targets, n_streams=4)
    got = np.asarray(
        sw_scores_stream(
            b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
            interpret=True, tile=128, score_width=W,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_scorebank_stream_biased_long_database():
    """ScoreBank(stream, score_width) serves long queries on the chained
    wavefront, bit-exact vs the biased oracle."""
    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig
    from swtpu.oracle import sw_score_single_biased

    rng = np.random.default_rng(21)
    W = 10
    query = np.tile(np.arange(4, dtype=np.int8), 40)  # 160 nt
    targets = [query.copy()] + [
        rng.integers(0, 4, size=int(rng.integers(4, 60))).astype(np.int8)
        for _ in range(8)
    ]
    want = np.array(
        [sw_score_single_biased(query, t, score_width=W) for t in targets],
        np.int32,
    )
    bank = ScoreBank(SWConfig(score_width=W), backend="stream", interpret=True)
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, want)


def test_loaded_db_biased_long_query():
    """score_width + long queries ride the device-resident database too
    (chained biased tiles on the kernel-layout entry)."""
    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig
    from swtpu.oracle import sw_score_single_biased

    rng = np.random.default_rng(22)
    W = 9
    targets = [rng.integers(0, 4, size=int(rng.integers(4, 50))).astype(np.int8)
               for _ in range(7)]
    bank = ScoreBank(SWConfig(score_width=W), backend="stream", interpret=True)
    db = bank.load_database(targets)
    for qlen in (60, 140, 256):
        query = np.tile(np.arange(4, dtype=np.int8), qlen // 4 + 1)[:qlen]
        want = np.array(
            [sw_score_single_biased(query, t, score_width=W) for t in targets],
            np.int32,
        )
        res = bank.score_loaded(query, db)
        np.testing.assert_array_equal(res.scores, want)
