"""Many-queries-vs-one-database serving demo.

The inversion of the reference's per-query library streaming: pack the
database once, keep it resident on the device, and serve a stream of
queries where each job ships only its query (ScoreBank.load_database /
score_loaded — see ARCHITECTURE.md 'Device-resident databases').

Runs on the GPU when JAX finds one; on the CPU the stream kernel runs in
the Pallas interpreter.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

from swtpu.bank import ScoreBank
from swtpu.oracle import score_many_vs_one


def run():
    rng = np.random.default_rng(0)
    n_reads = 2000
    targets = [
        rng.integers(0, 4, size=int(rng.integers(30, 120))).astype(np.int8)
        for _ in range(n_reads)
    ]
    bank = ScoreBank(backend="stream")
    t0 = time.perf_counter()
    db = bank.load_database(targets)
    print(f"loaded {n_reads} reads in {time.perf_counter()-t0:.2f}s "
          f"(resident stream {np.shape(db.stream)})")

    for qlen in (32, 128, 400):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        res = bank.score_loaded(query, db)
        want = score_many_vs_one(query, targets)
        ok = np.array_equal(res.scores, want)
        top = res.top_k(3)
        print(
            f"query {qlen:>4} nt: {res.elapsed_s*1e3:7.1f} ms, "
            f"{res.gcups:6.2f} GCUPS, top-3 {top}, "
            f"oracle parity {'OK' if ok else 'FAIL'}"
        )
        assert ok

    # best-hit-only serving: the top-K cut runs on the device, only 2k
    # scalars come back
    query = rng.integers(0, 4, size=64).astype(np.int8)
    top = bank.topk_loaded(query, db, k=5)
    assert top == bank.score_loaded(query, db).top_k(5)
    print(f"on-device top-5: {top}")

    # pipelined multi-query: every kernel enqueues before any result lands
    queries = [rng.integers(0, 4, size=80).astype(np.int8) for _ in range(4)]
    t0 = time.perf_counter()
    results = bank.score_loaded_many(queries, db)
    print(f"4 pipelined queries in {time.perf_counter()-t0:.2f}s")
    for q, res in zip(queries, results):
        assert np.array_equal(res.scores, score_many_vs_one(q, targets))
    print("all parity OK")


if __name__ == "__main__":
    run()
