"""Data-integrity guards on packed tensors.

The reference carries odd-parity bits on every hardware bus and aggregates
13 parity-error detectors into a WED error word the host decodes
(capi_sample_aligner/hdl-verliog/afu.v:73-76,151; check_errors in
software-C,C++/src/main_test.c:64-100).  The analog here (SURVEY.md §5):
cheap structural validation of every packed batch before dispatch and of
results after — catching packer bugs, corrupted transfers, and contract
violations the way parity catches flipped bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from swtpu.ops.common import Q_PAD, T_PAD


class IntegrityError(ValueError):
    """A packed batch violates the framework's data contract."""


def check_packed_query(q: np.ndarray, q_lens: Optional[np.ndarray] = None) -> None:
    _check_codes(q, Q_PAD, "query", q_lens)


def check_packed_target(t: np.ndarray, t_lens: Optional[np.ndarray] = None) -> None:
    _check_codes(t, T_PAD, "target", t_lens)


def _check_codes(arr: np.ndarray, pad: int, what: str, lens) -> None:
    a = np.asarray(arr)
    if a.ndim != 2:
        raise IntegrityError(f"{what} batch must be 2-D, got {a.shape}")
    bad = ~np.isin(a, (0, 1, 2, 3, pad))
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise IntegrityError(
            f"{what}[{i},{j}] = {int(a[i, j])} is not a base code or {pad=}"
        )
    if lens is not None:
        lens = np.asarray(lens)
        cols = np.arange(a.shape[1])[None, :]
        in_range = cols < lens[:, None]
        if (np.where(in_range, a, 0) == pad).any():
            raise IntegrityError(f"{what}: pad code inside declared length")
        if (np.where(in_range, pad, a) != pad).any():
            raise IntegrityError(f"{what}: real code beyond declared length")


def check_scores(scores: np.ndarray, q_lens, t_lens, match: int) -> None:
    """Scores must be in [0, match * min(len_q, len_t)] — the algebraic
    bound every correct run satisfies (the 'error word' of this framework)."""
    s = np.asarray(scores)
    if (s < 0).any():
        raise IntegrityError("negative score (clamp violated)")
    bound = match * np.minimum(np.asarray(q_lens, np.int64), np.asarray(t_lens, np.int64))
    over = s > bound
    if over.any():
        i = int(np.flatnonzero(over)[0])
        raise IntegrityError(
            f"score[{i}]={int(s[i])} exceeds bound {int(bound[i])}"
        )


def check_stream_batch(batch) -> None:
    """Validate a packed :class:`swtpu.bank.streams.StreamBatch` before
    dispatch — the parity check of the flagship stream path (the reference
    guards every bus, afu.v:73-76; swtpu guards the path the product runs):

    - query register codes are bases or the query sentinel;
    - stream chars are bases (optionally first-char-flagged) or the drain
      pad, which never carries a flag;
    - every emission coordinate indexes inside the [S, T] strip (or is the
      -1 zero-length-read sentinel).
    """
    from swtpu.bank.streams import FLAG, STREAM_PAD

    q = np.asarray(batch.q)
    if q.ndim != 2:
        raise IntegrityError(f"stream query register must be 2-D, got {q.shape}")
    bad = ~np.isin(q, (0, 1, 2, 3, Q_PAD))
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise IntegrityError(
            f"stream query[{i},{j}] = {int(q[i, j])} is not a base code or "
            f"pad {Q_PAD}"
        )
    stream = np.asarray(batch.stream)
    if stream.ndim != 2:
        raise IntegrityError(f"stream must be 2-D, got {stream.shape}")
    allowed = (0, 1, 2, 3, STREAM_PAD, FLAG, FLAG | 1, FLAG | 2, FLAG | 3)
    bad = ~np.isin(stream, allowed)
    if bad.any():
        i, j = np.argwhere(bad)[0]
        raise IntegrityError(
            f"stream[{i},{j}] = {int(stream[i, j])} is not a (flagged) base "
            f"code or pad {STREAM_PAD}"
        )
    S, T = stream.shape
    es = np.asarray(batch.emit_stream)
    ep = np.asarray(batch.emit_step)
    if ((es < 0) | (es >= S)).any():
        i = int(np.flatnonzero((es < 0) | (es >= S))[0])
        raise IntegrityError(
            f"emit_stream[{i}] = {int(es[i])} outside [0, {S})"
        )
    if ((ep < -1) | (ep >= T)).any():
        i = int(np.flatnonzero((ep < -1) | (ep >= T))[0])
        raise IntegrityError(
            f"emit_step[{i}] = {int(ep[i])} outside [-1, {T})"
        )


def checksum(arr: np.ndarray) -> int:
    """Order-sensitive checksum for cross-host result cross-checks."""
    a = np.ascontiguousarray(arr)
    import zlib

    return zlib.crc32(a.tobytes()) & 0xFFFFFFFF
