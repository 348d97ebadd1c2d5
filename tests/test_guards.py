"""Integrity guards (the parity-checking analog)."""

import numpy as np
import pytest

from swtpu.bank import ScoreBank
from swtpu.config import SWConfig
from swtpu.oracle import score_many_vs_one
from swtpu.utils.guards import (
    IntegrityError,
    check_packed_query,
    check_packed_target,
    check_scores,
    checksum,
)


def test_valid_batch_passes():
    q = np.array([[0, 1, 2, 3, 5, 5]], np.int8)
    check_packed_query(q, np.array([4]))
    t = np.array([[3, 2, 4, 4]], np.int8)
    check_packed_target(t, np.array([2]))


def test_bad_code_detected():
    with pytest.raises(IntegrityError):
        check_packed_query(np.array([[0, 9]], np.int8))


def test_pad_inside_length_detected():
    with pytest.raises(IntegrityError):
        check_packed_target(np.array([[4, 1]], np.int8), np.array([2]))


def test_real_code_beyond_length_detected():
    with pytest.raises(IntegrityError):
        check_packed_target(np.array([[1, 1]], np.int8), np.array([1]))


def test_score_bound():
    check_scores(np.array([10]), [4], [8], match=5)  # bound 20
    with pytest.raises(IntegrityError):
        check_scores(np.array([25]), [4], [8], match=5)
    with pytest.raises(IntegrityError):
        check_scores(np.array([-1]), [4], [8], match=5)


def test_scorebank_with_integrity_on():
    rng = np.random.default_rng(0)
    targets = [rng.integers(0, 4, size=rng.integers(4, 90)).astype(np.int8) for _ in range(15)]
    query = rng.integers(0, 4, size=20).astype(np.int8)
    bank = ScoreBank(SWConfig(target_buckets=(32, 128)), backend="scan", verify_integrity=True)
    res = bank.score_database(query, targets)
    np.testing.assert_array_equal(res.scores, score_many_vs_one(query, targets))


def test_checksum_stable():
    a = np.arange(100, dtype=np.int32)
    assert checksum(a) == checksum(a.copy())
    b = a.copy(); b[3] += 1
    assert checksum(a) != checksum(b)


def test_corruption_injection_end_to_end():
    """parity_inject.c analog (pslse-master/test/tests/parity_inject.c):
    corruption injected between pack and dispatch (codes) or score and
    scatter (scores) must be rejected in situ by verify_integrity."""
    import pytest

    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig
    from swtpu.testing.faults import FaultConfig, score_database_with_faults
    from swtpu.utils.guards import IntegrityError

    rng = np.random.default_rng(3)
    targets = [
        rng.integers(0, 4, size=rng.integers(4, 40)).astype(np.int8)
        for _ in range(12)
    ]
    query = rng.integers(0, 4, size=16).astype(np.int8)
    bank = ScoreBank(
        SWConfig(target_buckets=(32, 64)), backend="scan",
        verify_integrity=True,
    )
    for kind in ("codes", "scores"):
        fc = FaultConfig(seed=7, corrupt_percent=100, corrupt_kind=kind)
        with pytest.raises(IntegrityError):
            score_database_with_faults(bank, query, targets, fc)
    # control: same pipeline, no corruption -> exact scores
    from swtpu.oracle import score_many_vs_one

    fc = FaultConfig(seed=7, corrupt_percent=0)
    scores, inj = score_database_with_faults(bank, query, targets, fc)
    np.testing.assert_array_equal(scores, score_many_vs_one(query, targets))
    assert inj.injected_corruptions == 0


# ------------------------- stream-path guards (round 4: VERDICT weak #1) --


def _mk_stream_bank():
    return ScoreBank(SWConfig(), backend="stream", interpret=True,
                     verify_integrity=True)


def test_check_stream_batch_valid():
    from swtpu.bank.streams import pack_streams
    from swtpu.utils.guards import check_stream_batch

    rng = np.random.default_rng(0)
    targets = [rng.integers(0, 4, size=rng.integers(3, 30)).astype(np.int8)
               for _ in range(9)]
    q = rng.integers(0, 4, size=17).astype(np.int8)
    check_stream_batch(pack_streams(q, targets, n_streams=4))


@pytest.mark.parametrize("mutate", [
    lambda b: b.stream.__setitem__((0, 1), 6),          # invalid char
    lambda b: b.stream.__setitem__((0, 0), 4 | 8),      # flagged pad
    lambda b: b.q.__setitem__((0, 0), 9),               # invalid query code
    lambda b: b.emit_stream.__setitem__(0, 99),         # stream out of range
    lambda b: b.emit_step.__setitem__(0, 10 ** 9),      # step out of range
    lambda b: b.emit_step.__setitem__(0, -2),           # below -1 sentinel
])
def test_check_stream_batch_catches(mutate):
    from swtpu.bank.streams import pack_streams
    from swtpu.utils.guards import check_stream_batch

    rng = np.random.default_rng(1)
    targets = [rng.integers(0, 4, size=rng.integers(3, 30)).astype(np.int8)
               for _ in range(9)]
    q = rng.integers(0, 4, size=17).astype(np.int8)
    b = pack_streams(q, targets, n_streams=4)
    mutate(b)
    with pytest.raises(IntegrityError):
        check_stream_batch(b)


def test_stream_path_catches_corrupt_batch(monkeypatch):
    """A flipped stream byte is caught in situ on the DEFAULT stream path,
    BEFORE the kernel dispatches (the guard runs between pack and launch)."""
    import swtpu.bank.streams as streams_mod

    real_pack = streams_mod.pack_streams

    def corrupting_pack(*a, **kw):
        b = real_pack(*a, **kw)
        b.stream[0, 0] = 6  # not a code, not a flagged code, not the pad
        return b

    monkeypatch.setattr(streams_mod, "pack_streams", corrupting_pack)
    rng = np.random.default_rng(2)
    targets = [rng.integers(0, 4, size=10).astype(np.int8) for _ in range(6)]
    query = rng.integers(0, 4, size=12).astype(np.int8)
    with pytest.raises(IntegrityError):
        _mk_stream_bank().score_database(query, targets)


def test_stream_path_catches_corrupt_scores(monkeypatch):
    """An over-bound result on the stream path is caught after gather (the
    result-bus parity analog) — the kernel is stubbed so no Pallas build."""
    import swtpu.ops.pallas_stream as ps_mod

    monkeypatch.setattr(
        ps_mod, "sw_scores_stream",
        lambda q, stream, es, ep, *a, **kw: np.full(len(es), 10 ** 6, np.int32),
    )
    rng = np.random.default_rng(3)
    targets = [rng.integers(0, 4, size=10).astype(np.int8) for _ in range(6)]
    query = rng.integers(0, 4, size=12).astype(np.int8)
    with pytest.raises(IntegrityError):
        _mk_stream_bank().score_database(query, targets)


def test_pairs_stream_path_catches_corruption(monkeypatch):
    import swtpu.bank.streams as streams_mod
    import swtpu.ops.pallas_stream as ps_mod

    rng = np.random.default_rng(4)
    queries = [rng.integers(0, 4, size=100).astype(np.int8) for _ in range(4)]
    targets = [rng.integers(0, 4, size=30).astype(np.int8) for _ in range(4)]

    real_pack = streams_mod.pack_pair_streams

    def corrupting_pack(*a, **kw):
        b = real_pack(*a, **kw)
        b.emit_step[0] = 10 ** 9
        return b

    monkeypatch.setattr(streams_mod, "pack_pair_streams", corrupting_pack)
    with pytest.raises(IntegrityError):
        _mk_stream_bank().score_pairs(queries, targets)
    monkeypatch.undo()

    monkeypatch.setattr(
        ps_mod, "sw_scores_stream",
        lambda q, stream, es, ep, *a, **kw: np.full(len(es), 10 ** 6, np.int32),
    )
    with pytest.raises(IntegrityError):
        _mk_stream_bank().score_pairs(queries, targets)


def test_long_stream_path_catches_corrupt_batch(monkeypatch):
    import swtpu.bank.streams as streams_mod

    real_pack = streams_mod.pack_streams

    def corrupting_pack(*a, **kw):
        b = real_pack(*a, **kw)
        b.stream[0, 2] = 12  # flagged pad-class garbage
        return b

    monkeypatch.setattr(streams_mod, "pack_streams", corrupting_pack)
    rng = np.random.default_rng(5)
    targets = [rng.integers(0, 4, size=10).astype(np.int8) for _ in range(6)]
    query = rng.integers(0, 4, size=200).astype(np.int8)  # chained tiles
    with pytest.raises(IntegrityError):
        _mk_stream_bank().score_database(query, targets)
