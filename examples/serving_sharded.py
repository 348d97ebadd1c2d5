"""Mesh-sharded device-resident serving demo.

The reference's library is resident per scoring module across the bank
(`MODULES` feeders, ScoreBank_v2.v:77-139) with the query broadcast to
every module (`ld_q`, v2.v:99-102).  Here each mesh device holds its shard
of the packed streams in its memory; every query is one shard_map dispatch
shipping only the replicated query, with results either as the full
read-order score vector or a collective top-K (2k scalars D2H).

Runs over every visible GPU when JAX finds one, else on an 8-device
virtual CPU mesh (the stream kernel in the Pallas interpreter).
"""

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# only the CPU platform reads this: 8 virtual devices when there is no GPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np

from swtpu.bank import ScoreBank
from swtpu.oracle import score_many_vs_one
from swtpu.parallel import make_mesh


def run():
    import jax

    rng = np.random.default_rng(0)
    n_reads = 1600
    targets = [
        rng.integers(0, 4, size=int(rng.integers(30, 120))).astype(np.int8)
        for _ in range(n_reads)
    ]
    bank = ScoreBank(backend="stream")
    mesh = make_mesh()  # every visible device = one resident feeder bank
    t0 = time.perf_counter()
    db = bank.load_database_sharded(targets, mesh)
    print(
        f"loaded {n_reads} reads across {db.n_shards} device shards in "
        f"{time.perf_counter()-t0:.2f}s (per-shard stream "
        f"{np.shape(db.stream)[1:]} resident)"
    )

    for qlen in (48, 128, 250):
        query = rng.integers(0, 4, size=qlen).astype(np.int8)
        res = bank.score_loaded_sharded(query, db)
        want = score_many_vs_one(query, targets)
        ok = np.array_equal(res.scores, want)
        print(
            f"query {qlen:>4} nt: {res.elapsed_s*1e3:7.1f} ms, "
            f"{res.gcups:6.2f} GCUPS, oracle parity "
            f"{'OK' if ok else 'FAIL'}"
        )
        assert ok

    # mesh-wide best hits: per-shard cut on each device + collective merge,
    # only 2k scalars cross D2H — tie order identical to the host sort
    query = rng.integers(0, 4, size=100).astype(np.int8)
    top = bank.topk_loaded_sharded(query, db, k=5)
    host = bank.score_loaded_sharded(query, db).top_k(5)
    print(f"collective top-5: {top} (host-consistent: {top == host})")
    assert top == host

    # pipelined many-query serving: every dispatch enqueued before any
    # result materializes
    queries = [rng.integers(0, 4, size=80).astype(np.int8) for _ in range(8)]
    t0 = time.perf_counter()
    results = bank.score_loaded_many_sharded(queries, db)
    dt = time.perf_counter() - t0
    print(
        f"pipelined {len(queries)} queries in {dt*1e3:.1f} ms "
        f"({len(queries)/dt:.1f} queries/s on "
        f"{len(jax.devices())} devices)"
    )


if __name__ == "__main__":
    run()
