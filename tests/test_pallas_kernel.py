"""Dense column path == oracle: the cases of the former column kernel,
now run by the plain scan (`sw_scores_scan`), which XLA fuses on every
backend."""

import numpy as np
import pytest

from swtpu.config import Penalties
from swtpu.ops import sentinel_pad_batch
from swtpu.ops.scan import sw_scores_scan
from swtpu.oracle import sw_score_batch


def _random_ragged(rng, B, m_max, n_max):
    q_lens = rng.integers(1, m_max + 1, size=B)
    t_lens = rng.integers(1, n_max + 1, size=B)
    q = rng.integers(0, 4, size=(B, m_max)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n_max)).astype(np.int8)
    return q, q_lens, t, t_lens


@pytest.mark.parametrize(
    "B,m,n,seed",
    [(8, 8, 8, 0), (16, 32, 32, 1), (4, 16, 64, 3)],
)
def test_pallas_matches_oracle(B, m, n, seed):
    rng = np.random.default_rng(seed)
    q, q_lens, t, t_lens = _random_ragged(rng, B, m, n)
    want = sw_score_batch(q, t, q_lens, t_lens)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp))
    np.testing.assert_array_equal(got, want)


def test_pallas_custom_penalties():
    rng = np.random.default_rng(7)
    q, q_lens, t, t_lens = _random_ragged(rng, 8, 24, 24)
    pen = Penalties(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    want = sw_score_batch(q, t, q_lens, t_lens, pen)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp, pen))
    np.testing.assert_array_equal(got, want)


def test_pallas_block_padding():
    # B not a multiple of block_pairs: padded pairs must not leak
    rng = np.random.default_rng(11)
    q, q_lens, t, t_lens = _random_ragged(rng, 5, 16, 16)
    want = sw_score_batch(q, t, q_lens, t_lens)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp))
    np.testing.assert_array_equal(got, want)


def test_pallas_long_query_sublane():
    # m > 128: the query dim extends freely (the chaining-ports intent);
    # the prefix scan runs log2(m) steps
    rng = np.random.default_rng(21)
    q, q_lens, t, t_lens = _random_ragged(rng, 4, 136, 16)
    want = sw_score_batch(q, t, q_lens, t_lens)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp))
    np.testing.assert_array_equal(got, want)


# Long queries up to the LEN_WIDTH=12 -> 4095-base envelope
# (ScoreBank/ScoreBank_v2.v:14-15).
@pytest.mark.slow
@pytest.mark.parametrize(
    "B,m,n,seed",
    [(6, 300, 48, 5), (4, 1024, 32, 6), (3, 4000, 24, 7)],
)
def test_pallas_chained_long_query(B, m, n, seed):
    rng = np.random.default_rng(seed)
    q_lens = rng.integers(m // 2, m + 1, size=B)
    t_lens = rng.integers(1, n + 1, size=B)
    q = rng.integers(0, 4, size=(B, m)).astype(np.int8)
    t = rng.integers(0, 4, size=(B, n)).astype(np.int8)
    want = sw_score_batch(q, t, q_lens, t_lens)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp))
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_pallas_chained_gap_spans_tiles():
    # a 300-base gap inside one long query column
    rng = np.random.default_rng(9)
    tseq = rng.integers(0, 4, size=80).astype(np.int8)
    # query = target's first 40 bases + 300 junk-free inserts + last 40
    q = np.concatenate(
        [tseq[:40], rng.integers(0, 4, size=300).astype(np.int8), tseq[40:]]
    )
    qs = q[None, :]
    ts = tseq[None, :]
    want = sw_score_batch(qs, ts, np.array([len(q)]), np.array([80]))
    qp, tp = sentinel_pad_batch(
        qs, np.array([len(q)]), ts, np.array([80])
    )
    got = np.asarray(sw_scores_scan(qp, tp))
    np.testing.assert_array_equal(got, want)


def test_pallas_f32_state():
    # the case the float32-state column kernel ran; the scan is int32
    rng = np.random.default_rng(22)
    q, q_lens, t, t_lens = _random_ragged(rng, 8, 24, 24)
    want = sw_score_batch(q, t, q_lens, t_lens)
    qp, tp = sentinel_pad_batch(q, q_lens, t, t_lens)
    got = np.asarray(sw_scores_scan(qp, tp))
    np.testing.assert_array_equal(got, want)
