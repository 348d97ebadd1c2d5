"""Time swtpu's main scoring path on the GPU, in one process.

    python bench.py [--reads 1048576] [--query-len 128] [--reps 3]
                    [--tile T] [--streams S] [--seed 0]

Scores a read library made from --seed (lengths uniform in 100-250 nt)
against one query through ScoreBank.score_database (host packing, transfer,
kernel and score read-back) and through a device-resident database
(ScoreBank.load_database + score_loaded).  Compilation is reported as
set-up; every timed call ends with the scores on the host.  --tile and
--streams override the platform table (swtpu.device) for tuning sweeps.

Prints the card's name and power limit, then one JSON line.  Fails without
a GPU: a CPU number is never reported under a device metric.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np


def _timed(fn, reps):
    t0 = time.perf_counter()
    fn()
    setup = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return setup, times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1 << 20)
    ap.add_argument("--query-len", type=int, default=128)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--streams", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX's first device is on {dev.platform!r})",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(card)

    from swtpu.bank import ScoreBank
    from swtpu.config import SWConfig
    from swtpu.device import enable_compile_cache
    from swtpu.ops.common import T_PAD

    enable_compile_cache()
    rng = np.random.default_rng(args.seed)
    lens = rng.integers(100, 251, size=args.reads).astype(np.int32)
    mat = rng.integers(0, 4, size=(args.reads, 250)).astype(np.int8)
    mat[np.arange(250)[None, :] >= lens[:, None]] = T_PAD
    query = rng.integers(0, 4, size=args.query_len).astype(np.int8)
    cells = int(lens.astype(np.int64).sum()) * args.query_len

    bank = ScoreBank(SWConfig(stream_tile=args.tile, streams=args.streams))
    print(f"backend {bank.backend}; {bank.plan}", flush=True)
    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card, "reads": args.reads, "query_len": args.query_len,
        "cells": cells, "backend": bank.backend,
        "tile": bank.plan.tile, "streams": bank.plan.streams,
    }
    paths = {
        "score_database": lambda: bank.score_database(query, (mat, lens)),
    }
    if bank.backend == "stream":
        t0 = time.perf_counter()
        db = bank.load_database((mat, lens))
        jax.block_until_ready(db.stream)
        result["load_database_s"] = time.perf_counter() - t0
        paths["score_loaded"] = lambda: bank.score_loaded(query, db)
    for name, fn in paths.items():
        setup, times = _timed(fn, args.reps)
        best = min(times)
        result[name] = {
            "setup_s": setup, "warm_s": times, "reads_per_s": args.reads / best,
            "gcups": cells / best / 1e9,
        }
        print(f"{name}: set-up {setup:.3f} s; warm {times} s; "
              f"{args.reads / best:.1f} reads/s; {cells / best / 1e9:.2f} "
              "GCUPS over real cells", flush=True)
    result["peak_bytes_in_use"] = int(
        (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
