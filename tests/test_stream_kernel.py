"""Streamed wavefront kernel: packing, kernel parity, ScoreBank backend.

Off the GPU the kernel runs in the Pallas interpreter (the `interpret`
fixture); the same tests compile it on a GPU."""

import numpy as np
import pytest

from swtpu.bank.streams import pack_streams, score_streams
from swtpu.config import Penalties, SWConfig
from swtpu.oracle import score_many_vs_one


def _targets(rng, n, lo=3, hi=60):
    return [rng.integers(0, 4, size=rng.integers(lo, hi)).astype(np.int8) for _ in range(n)]


def test_pack_streams_structure():
    rng = np.random.default_rng(0)
    targets = _targets(rng, 10)
    query = rng.integers(0, 4, size=16).astype(np.int8)
    from swtpu.ops.pallas_stream import STEP_CHUNK

    b = pack_streams(query, targets, n_streams=4)
    assert b.stream.shape[1] % STEP_CHUNK == 0
    # every target's first char is flagged exactly once per target
    n_flags = int((b.stream >= 8).sum())
    assert n_flags == len(targets)
    # emission steps within bounds and unique per (stream, step)
    coords = set(zip(b.emit_stream.tolist(), b.emit_step.tolist()))
    assert len(coords) == len(targets)
    assert b.emit_step.max() < b.stream.shape[1]
    assert b.cells == sum(16 * len(t) for t in targets)


def test_stream_kernel_matches_oracle(interpret):
    rng = np.random.default_rng(1)
    targets = _targets(rng, 12)
    query = rng.integers(0, 4, size=17).astype(np.int8)
    want = score_many_vs_one(query, targets)
    got = score_streams(query, targets, n_streams=8, interpret=interpret)
    np.testing.assert_array_equal(got, want)


def test_stream_kernel_custom_penalties_and_empty_reads(interpret):
    rng = np.random.default_rng(2)
    targets = _targets(rng, 6)
    targets.insert(2, np.zeros((0,), np.int8))  # empty read scores 0
    query = rng.integers(0, 4, size=9).astype(np.int8)
    pen = Penalties(match=3, mismatch=-1, gap_open=-3, gap_extend=-2)
    want = score_many_vs_one(query, targets, pen)
    got = score_streams(query, targets, n_streams=4, penalties=pen, interpret=interpret)
    np.testing.assert_array_equal(got, want)
    assert got[2] == 0


def test_scorebank_stream_backend(interpret):
    rng = np.random.default_rng(3)
    targets = _targets(rng, 20, lo=5, hi=100)
    query = rng.integers(0, 4, size=31).astype(np.int8)
    want = score_many_vs_one(query, targets)
    from swtpu.bank import ScoreBank

    bank = ScoreBank(SWConfig(), backend="stream", interpret=interpret)
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == sum(31 * len(t) for t in targets)


@pytest.mark.parametrize("segments", [2, 4])
def test_segmented_stream_matches_oracle(segments, interpret):
    # the reads and short queries that once packed `segments` queries per
    # column; a short query now takes a short tile, one query per stream
    rng = np.random.default_rng(segments)
    targets = _targets(rng, 14, lo=2, hi=50)
    qcap = 128 // segments
    query = rng.integers(0, 4, size=qcap - 3).astype(np.int8)
    want = score_many_vs_one(query, targets)
    got = score_streams(
        query, targets, n_streams=4 * segments, interpret=interpret,
    )
    np.testing.assert_array_equal(got, want)


def test_stream_backend_long_query_fallback(interpret):
    # queries longer than one tile chain tiles transparently
    rng = np.random.default_rng(77)
    targets = _targets(rng, 8, lo=5, hi=60)
    query = rng.integers(0, 4, size=200).astype(np.int8)
    want = score_many_vs_one(query, targets)
    from swtpu.bank import ScoreBank

    bank = ScoreBank(SWConfig(target_buckets=(32, 128)), backend="stream", interpret=interpret)
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, want)


def test_stream_wire_roundtrip_and_parity(interpret):
    # 2-bit wire format: pack_stream_wire -> device unpack -> same scores
    from swtpu.bank.streams import pack_stream_wire, pack_streams
    from swtpu.ops.pallas_stream import (
        sw_scores_stream, sw_scores_stream_packed, unpack_stream_wire,
    )

    rng = np.random.default_rng(55)
    targets = _targets(rng, 18, lo=3, hi=60)
    query = rng.integers(0, 4, size=23).astype(np.int8)
    want = score_many_vs_one(query, targets)
    b = pack_streams(query, targets, n_streams=8)
    codes, flags = pack_stream_wire(b.stream)
    # wire is 2.5 bits/char
    assert codes.nbytes + flags.nbytes == b.stream.nbytes // 4 + b.stream.nbytes // 8
    # unpack preserves codes+flags (pads lose identity, which is score-safe)
    un = np.asarray(unpack_stream_wire(codes, flags))
    real = b.stream != 4  # non-pad chars survive exactly
    np.testing.assert_array_equal(un[real], b.stream[real])
    got = np.asarray(
        sw_scores_stream_packed(
            b.q, codes, flags, b.emit_stream, b.emit_step.astype(np.int32),
            interpret=interpret,
        )
    )
    np.testing.assert_array_equal(got, want)
    # and matches the unpacked kernel bit-for-bit
    got_ref = np.asarray(
        sw_scores_stream(
            b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
            interpret=interpret,
        )
    )
    np.testing.assert_array_equal(got, got_ref)


@pytest.mark.parametrize(
    "rows",
    [2, 4, 8, pytest.param(16, marks=pytest.mark.slow)],
)
def test_multirow_stream_matches_oracle(rows, interpret):
    # `rows` query rows per thread: a 97-row query chains ceil(97/rows)
    # tiles; every tile height gives the same scores
    rng = np.random.default_rng(100 + rows)
    targets = _targets(rng, 17, lo=2, hi=70)
    query = rng.integers(0, 4, size=97).astype(np.int8)
    want = score_many_vs_one(query, targets)
    got = score_streams(
        query, targets, n_streams=8, interpret=interpret, tile=rows
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "rows,segments",
    [
        (2, 2), (4, 4), (8, 2),
        pytest.param(16, 2, marks=pytest.mark.slow),
        pytest.param(16, 4, marks=pytest.mark.slow),
    ],
)
def test_multirow_segmented_stream(rows, segments, interpret):
    # the short-query cases that once packed `segments` queries per column,
    # at tile height `rows`, one query per stream
    rng = np.random.default_rng(200 + rows + segments)
    targets = _targets(rng, 13, lo=2, hi=40)
    qcap = 128 // segments
    query = rng.integers(0, 4, size=qcap - 5).astype(np.int8)
    want = score_many_vs_one(query, targets)
    got = score_streams(
        query, targets, n_streams=4 * segments, interpret=interpret,
        tile=rows,
    )
    np.testing.assert_array_equal(got, want)


def test_multirow_full_length_query(interpret):
    # full 128-base query in 4-row tiles: 32 chained tiles
    rng = np.random.default_rng(300)
    targets = _targets(rng, 9, lo=5, hi=90)
    query = rng.integers(0, 4, size=128).astype(np.int8)
    want = score_many_vs_one(query, targets)
    got = score_streams(
        query, targets, n_streams=8, interpret=interpret, tile=4
    )
    np.testing.assert_array_equal(got, want)


def test_large_ragged_list_densifies_to_greedy_packing():
    # lists >= 1024 reads route through the native dense plan/fill path;
    # the packing must stay bit-identical to the per-read greedy loop
    from swtpu.bank.streams import pack_streams

    rng = np.random.default_rng(7)
    reads = [
        rng.integers(0, 4, size=int(n)).astype(np.int8)
        for n in rng.integers(0, 90, size=1536)
    ]
    q = rng.integers(0, 4, size=64).astype(np.int8)
    big = pack_streams(q, reads, n_streams=32)
    # force the pure-greedy path by packing in sub-threshold halves and
    # comparing a full greedy repack of the same reads
    ref_chunks = pack_streams(q, reads[:1000], n_streams=32)
    again = pack_streams(q, reads, n_streams=32)
    np.testing.assert_array_equal(big.emit_stream, again.emit_stream)
    # greedy equivalence on the shared prefix: emission coordinates of the
    # first 1000 reads match the sub-threshold greedy pack exactly
    np.testing.assert_array_equal(
        big.emit_stream[:1000], ref_chunks.emit_stream
    )
    np.testing.assert_array_equal(big.emit_step[:1000], ref_chunks.emit_step)
    assert big.cells == sum(len(t) for t in reads) * 64


def test_large_ragged_list_without_native_toolchain(monkeypatch):
    # regression (round-2 advisor, high): with the native packer unavailable,
    # a >=1024-read ragged list must fall back to the terminal greedy loop
    # instead of recursing pack_streams -> _pack_streams_dense -> pack_streams
    import swtpu.runtime.native as native

    monkeypatch.setattr(native, "native_available", lambda: False)
    rng = np.random.default_rng(11)
    reads = [
        rng.integers(0, 4, size=int(n)).astype(np.int8)
        for n in rng.integers(1, 50, size=1100)
    ]
    q = rng.integers(0, 4, size=40).astype(np.int8)
    b = pack_streams(q, reads, n_streams=16)
    assert b.cells == sum(len(t) for t in reads) * 40
    # same packing as the native/dense path would produce
    ref = pack_streams(q, reads[:512], n_streams=16)
    np.testing.assert_array_equal(b.emit_stream[:512], ref.emit_stream)
    np.testing.assert_array_equal(b.emit_step[:512], ref.emit_step)


def test_stream_long_kernel_matches_oracle(interpret):
    # query-tile chaining: a 300-row query as 3 tiles of 100 rows carrying
    # the last-row D/G strips between tiles (the reference's reserved
    # chaining ports, ScoreBank/ScoringModule_v1.1.v:36-54)
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(500)
    targets = _targets(rng, 8, lo=3, hi=50)
    query = rng.integers(0, 4, size=300).astype(np.int8)  # K=3 tiles
    want = score_many_vs_one(query, targets)
    b = pack_streams(query, targets, n_streams=8)
    got = np.asarray(
        sw_scores_stream(
            b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
            interpret=interpret, tile=128,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_stream_long_single_tile_matches_short_path(interpret):
    # a tile tall enough for the whole query (no chaining) must equal the
    # chained form of the same query
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(501)
    targets = _targets(rng, 6, lo=2, hi=40)
    query = rng.integers(0, 4, size=90).astype(np.int8)
    want = score_many_vs_one(query, targets)
    b = pack_streams(query, targets, n_streams=8)
    args = (b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32))
    one = np.asarray(sw_scores_stream(*args, interpret=interpret, tile=128))
    chained = np.asarray(sw_scores_stream(*args, interpret=interpret, tile=30))
    np.testing.assert_array_equal(one, want)
    np.testing.assert_array_equal(chained, want)


def test_stream_long_packed_wire_parity(interpret):
    # chained tiles on the 2-bit wire format: identical scores to the
    # unpacked chained kernel
    from swtpu.bank.streams import pack_stream_wire
    from swtpu.ops.pallas_stream import sw_scores_stream_packed

    rng = np.random.default_rng(503)
    targets = _targets(rng, 7, lo=3, hi=45)
    query = rng.integers(0, 4, size=200).astype(np.int8)  # K=2 tiles
    want = score_many_vs_one(query, targets)
    b = pack_streams(query, targets, n_streams=8)
    codes, flags = pack_stream_wire(b.stream)
    got = np.asarray(
        sw_scores_stream_packed(
            b.q, codes, flags, b.emit_stream, b.emit_step.astype(np.int32),
            interpret=interpret, tile=128,
        )
    )
    np.testing.assert_array_equal(got, want)


def test_scorebank_stream_long_query(interpret):
    # ScoreBank scores >1-tile queries on the chained stream path
    rng = np.random.default_rng(502)
    targets = _targets(rng, 10, lo=3, hi=60)
    query = rng.integers(0, 4, size=257).astype(np.int8)
    want = score_many_vs_one(query, targets)
    from swtpu.bank import ScoreBank

    bank = ScoreBank(SWConfig(), backend="stream", interpret=interpret)
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, want)
    assert res.cells == sum(257 * len(t) for t in targets)


@pytest.mark.slow
def test_fuzz_differential_sweep(interpret):
    """Seeded randomized differential sweep: random penalties, query
    lengths, tile heights, ragged (incl. empty) reads — every combination
    must match the numpy oracle bit-exactly.  The swtpu analog of PSLSE's
    seeded randomized regression (pslse.parms SEED ranges)."""
    rng = np.random.default_rng(0xF0220)
    for it in range(12):
        pen = Penalties(
            match=int(rng.integers(1, 9)),
            mismatch=-int(rng.integers(1, 9)),
            gap_open=-int(rng.integers(1, 14)),
            gap_extend=-int(rng.integers(1, 7)),
        )
        tile = int(rng.choice([4, 16, 64]))
        qlen = int(rng.integers(1, 129))
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        n = int(rng.integers(3, 25))
        targets = [
            rng.integers(0, 4, size=int(rng.integers(0, 80))).astype(np.int8)
            for _ in range(n)
        ]
        want = score_many_vs_one(query, targets, pen)
        got = score_streams(
            query, targets, n_streams=8, penalties=pen,
            interpret=interpret, tile=tile,
        )
        np.testing.assert_array_equal(
            got, want,
            err_msg=f"iter {it}: pen={pen} tile={tile} qlen={qlen}",
        )


@pytest.mark.slow
def test_fuzz_differential_long_and_biased(interpret):
    """Fuzz the chained long-query tiles and the biased wrap mode."""
    from swtpu.oracle import sw_score_single_biased
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(0xF0221)
    for it in range(6):
        qlen = int(rng.integers(129, 520))
        tile = int(rng.choice([32, 64, 128]))
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        targets = [
            rng.integers(0, 4, size=int(rng.integers(1, 60))).astype(np.int8)
            for _ in range(int(rng.integers(3, 12)))
        ]
        want = score_many_vs_one(query, targets)
        b = pack_streams(query, targets, n_streams=8)
        got = np.asarray(
            sw_scores_stream(
                b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
                interpret=interpret, tile=tile,
            )
        )
        np.testing.assert_array_equal(
            got, want, err_msg=f"long iter {it}: qlen={qlen} tile={tile}"
        )
    for it in range(6):
        W = int(rng.integers(6, 11))
        qlen = int(rng.integers(10, 120))
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        targets = [
            rng.integers(0, 4, size=int(rng.integers(1, 60))).astype(np.int8)
            for _ in range(8)
        ] + [query[: int(rng.integers(1, qlen + 1))].copy() for _ in range(3)]
        want = np.array(
            [sw_score_single_biased(query, t, score_width=W) for t in targets],
            np.int32,
        )
        tile = int(rng.choice([8, 32, 128]))
        b = pack_streams(query, targets, n_streams=4)
        got = np.asarray(
            sw_scores_stream(
                b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
                interpret=interpret, tile=tile, score_width=W,
            )
        )
        np.testing.assert_array_equal(
            got, want, err_msg=f"biased iter {it}: W={W} qlen={qlen} tile={tile}"
        )


# ---------------- regular-emission strided extraction (round 5) ----------


def test_detect_regular_emissions():
    from swtpu.bank.streams import detect_regular_emissions, pack_streams

    rng = np.random.default_rng(50)
    # equal-length round-robin: regular by construction
    t = rng.integers(0, 4, size=(16, 20)).astype(np.int8)
    q = rng.integers(0, 4, size=10).astype(np.int8)
    b = pack_streams(q, list(t), n_streams=4)
    assert b.emit_regular is not None
    first, stride, per = b.emit_regular
    assert stride == 20 and per == 4 and first == b.emit_step[0]
    # ragged: no pattern
    ragged = [rng.integers(0, 4, size=int(rng.integers(3, 30))).astype(np.int8)
              for _ in range(16)]
    br = pack_streams(q, ragged, n_streams=4)
    assert br.emit_regular is None
    # direct check on hand-built arrays
    r = np.arange(12)
    assert detect_regular_emissions(
        (r % 4).astype(np.int32), (r // 4) * 7 + 3, 4
    ) == (3, 7, 3)
    assert detect_regular_emissions(
        (r % 4).astype(np.int32), (r // 4) * 7 + 3, 5
    ) is None  # R not divisible by S


def test_stream_regular_extraction_matches_gather():
    """The strided-extract fast path (emit_regular) returns bit-identical
    read-order scores to the scattered gather — the round-4 extraction-tax
    fix must be invisible to results."""
    from swtpu.bank.streams import pack_streams
    from swtpu.ops.pallas_stream import sw_scores_stream
    from swtpu.oracle import score_many_vs_one

    rng = np.random.default_rng(51)
    q = rng.integers(0, 4, size=33).astype(np.int8)
    t = rng.integers(0, 4, size=(24, 17)).astype(np.int8)
    b = pack_streams(q, list(t), n_streams=8)
    assert b.emit_regular is not None
    want = score_many_vs_one(q, list(t))
    args = (b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32))
    got_fast = np.asarray(sw_scores_stream(
        *args, interpret=True, tile=16, emit_regular=b.emit_regular))
    got_slow = np.asarray(sw_scores_stream(*args, interpret=True, tile=16))
    np.testing.assert_array_equal(got_fast, want)
    np.testing.assert_array_equal(got_slow, want)


def test_stream_regular_extraction_segments_and_biased():
    from swtpu.bank.streams import pack_streams
    from swtpu.ops.pallas_stream import sw_scores_stream
    from swtpu.oracle import score_many_vs_one, sw_score_single_biased

    rng = np.random.default_rng(52)
    q = rng.integers(0, 4, size=20).astype(np.int8)
    t = rng.integers(0, 4, size=(32, 11)).astype(np.int8)
    b = pack_streams(q, list(t), n_streams=16)
    assert b.emit_regular is not None
    got = np.asarray(sw_scores_stream(
        b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
        interpret=True, emit_regular=b.emit_regular))
    np.testing.assert_array_equal(got, score_many_vs_one(q, list(t)))
    # biased wrap + regular extraction compose
    W = 6
    qb = np.tile(np.arange(4, dtype=np.int8), 8)
    tb = np.tile(qb[None, :], (8, 1))
    bb = pack_streams(qb, list(tb), n_streams=4)
    assert bb.emit_regular is not None
    want = np.array([sw_score_single_biased(qb, tt, score_width=W)
                     for tt in tb], np.int32)
    gotb = np.asarray(sw_scores_stream(
        bb.q, bb.stream, bb.emit_stream, bb.emit_step.astype(np.int32),
        interpret=True, score_width=W, emit_regular=bb.emit_regular))
    np.testing.assert_array_equal(gotb, want)


def test_stream_long_regular_extraction():
    from swtpu.ops.pallas_stream import sw_scores_stream
    from swtpu.oracle import score_many_vs_one

    rng = np.random.default_rng(53)
    q = rng.integers(0, 4, size=150).astype(np.int8)
    t = rng.integers(0, 4, size=(12, 25)).astype(np.int8)
    b = pack_streams(q, list(t), n_streams=4)
    assert b.emit_regular is not None
    got = np.asarray(sw_scores_stream(
        b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
        interpret=True, tile=64, emit_regular=b.emit_regular))
    np.testing.assert_array_equal(got, score_many_vs_one(q, list(t)))


@pytest.mark.slow
def test_fuzz_differential_regular_extraction(interpret):
    """Seeded sweep over equal-length configs: the strided regular
    extraction must be bit-identical to both the scattered gather and the
    oracle across random (S, tile, read length, batch) shapes — incl.
    biased wrap mode."""
    from swtpu.bank.streams import pack_streams
    from swtpu.oracle import sw_score_single_biased
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(0xF0522)
    for it in range(8):
        tile = int(rng.choice([8, 32, 64]))
        S = 4 * int(rng.choice([1, 2, 4]))
        n = int(rng.integers(3, 40))
        per = int(rng.integers(1, 5))
        B = S * per
        qlen = int(rng.integers(1, 129))
        W = int(rng.integers(6, 11)) if it % 2 else None
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
        if W is not None:
            t[0, :] = np.resize(query, n)  # push toward the wrap regime
        b = pack_streams(query, list(t), n_streams=S)
        assert b.emit_regular is not None, f"iter {it}: expected regular"
        if W is None:
            want = score_many_vs_one(query, list(t))
        else:
            want = np.array(
                [sw_score_single_biased(query, tt, score_width=W)
                 for tt in t], np.int32,
            )
        args = (b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32))
        kw = dict(interpret=interpret, tile=tile, score_width=W)
        fast = np.asarray(sw_scores_stream(
            *args, emit_regular=b.emit_regular, **kw))
        slow = np.asarray(sw_scores_stream(*args, **kw))
        msg = (f"iter {it}: S={S} tile={tile} n={n} "
               f"per={per} qlen={qlen} W={W}")
        np.testing.assert_array_equal(fast, want, err_msg=msg + " (fast)")
        np.testing.assert_array_equal(slow, want, err_msg=msg + " (slow)")


# ---------------- the GPU kernel's modes and contract ---------------------


def _modes_case(mode, rng):
    """(q [N, L] per-stream queries, targets, per-read query, width)."""
    if mode == "pairs":
        qs = [rng.integers(0, 4, size=n).astype(np.int8) for n in (12, 45, 70)]
        queries = [qs[i % 3] for i in range(14)]
        targets = _targets(rng, 14, lo=0, hi=60)
        return queries, targets, None
    L = {"exact": 40, "wrap": 60, "chained": 150}[mode]
    query = rng.integers(0, 4, size=L).astype(np.int8)
    targets = _targets(rng, 13, lo=0, hi=70)
    if mode == "wrap":
        targets += [query.copy(), query[:45].copy()]  # past a 7-bit ceiling
    return query, targets, 7 if mode == "wrap" else None


@pytest.mark.parametrize("mode", ["exact", "wrap", "chained", "pairs"])
def test_kernel_modes_match_oracle(mode, interpret):
    """Every mode the wavefront keeps, bit-exact against the oracle: exact
    scoring, W-bit wrap-parity, chained query tiles, and per-stream query
    registers (pairs)."""
    from swtpu.bank.streams import pack_pair_streams
    from swtpu.oracle import sw_score_single, sw_score_single_biased
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(700 + len(mode))
    query, targets, width = _modes_case(mode, rng)
    if mode == "pairs":
        b = pack_pair_streams(query, targets, n_streams=8)
        want = [sw_score_single(q, t) for q, t in zip(query, targets)]
    else:
        b = pack_streams(query, targets, n_streams=8)
        if width is None:
            want = score_many_vs_one(query, targets)
        else:
            want = [sw_score_single_biased(query, t, score_width=width)
                    for t in targets]
    got = np.asarray(sw_scores_stream(
        b.q, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
        tile=32, interpret=interpret, score_width=width,
        emit_regular=b.emit_regular,
    ))
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))
    if width is not None:
        assert got[-2] < score_many_vs_one(query, targets)[-2]  # wrap fired


@pytest.mark.parametrize(
    "n_streams,block,T,match",
    [(8, 6, 32, "power of two"), (12, 8, 32, "divide"), (8, 8, 40, "multiple")],
)
def test_kernel_rejects_bad_geometry(n_streams, block, T, match):
    from swtpu.ops.pallas_stream import sw_scores_stream

    q = np.zeros((n_streams, 4), np.int8)
    stream = np.full((n_streams, T), 4, np.int8)
    es = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match=match):
        sw_scores_stream(q, stream, es, es, block=block, interpret=True)


@pytest.mark.parametrize(
    "qlen,tile,want",
    [(0, 64, (1, 1)), (20, 64, (1, 20)), (64, 64, (1, 64)),
     (100, 64, (2, 50)), (128, 64, (2, 64)), (512, 64, (8, 64))],
)
def test_tile_rows_balances_tiles(qlen, tile, want):
    # K tiles of equal height: a short query takes a short tile
    from swtpu.ops.pallas_stream import tile_rows

    assert tile_rows(qlen, tile) == want


@pytest.mark.gpu
def test_full_width_kernel_on_gpu(gpu, plan):
    """The compiled kernel at the platform table's widths on a real
    library slice, bit-exact against the oracle batch."""
    from swtpu.oracle import sw_score_batch
    from swtpu.ops.pallas_stream import sw_scores_stream

    rng = np.random.default_rng(800)
    R = 4 * plan.streams
    lens = rng.integers(100, 251, size=R).astype(np.int32)
    mat = rng.integers(0, 4, size=(R, 250)).astype(np.int8)
    query = rng.integers(0, 4, size=128).astype(np.int8)
    b = pack_streams(query, mat, n_streams=plan.streams, lens=lens)
    got = np.asarray(sw_scores_stream(
        query, b.stream, b.emit_stream, b.emit_step.astype(np.int32),
        tile=plan.tile, block=plan.block,
    ))
    idx = rng.choice(R, 1000, replace=False)
    want = sw_score_batch(
        np.tile(query, (len(idx), 1)), mat[idx], np.full(len(idx), 128),
        lens[idx],
    )
    np.testing.assert_array_equal(got[idx], want)
