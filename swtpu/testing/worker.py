"""Multi-process scoring worker — one simulated host.

The hardware-free multi-host harness runs N of these as OS processes on
localhost under `jax.distributed` (CPU backend), the swtpu analog of the
reference's PSLSE strategy: "multi-node without a cluster = multiple OS
processes + sockets + a fake device" (SURVEY.md §4, pslse-master/test/
regress/regress.py:128-185).  Each worker owns a database shard, scores it,
and participates in the collective top-K merge; the driver
(swtpu.testing.regress) checks that every worker reports the identical
merged result.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--topk", type=int, default=4)
    ap.add_argument(
        "--lo", type=int, default=-1,
        help="explicit shard row range [lo, hi) — ragged shard sizes "
        "(database mode; default: equal split)",
    )
    ap.add_argument("--hi", type=int, default=-1)
    ap.add_argument("--cursor-fp", type=int, default=0,
                    help="job fingerprint stored in the cursor")
    ap.add_argument(
        "--cursor", default="",
        help="per-shard completion cursor file (WED status/progress analog, "
        "aligner_Header.h:28-49): written atomically once this shard's "
        "scores exist, so a rerun driver can resume the shard from disk",
    )
    ap.add_argument("--delay-ms", type=int, default=0, help="injected startup delay")
    ap.add_argument(
        "--adversary", default="",
        choices=["", "corrupt", "corrupt_wire"],
        help="act as a lying device (the PSLSE Test-AFU analog, "
        "pslse-master/test/afu/): 'corrupt' returns wrong scores with a "
        "consistent checksum (caught by the driver's oracle audit); "
        "'corrupt_wire' corrupts after checksumming (caught by the "
        "checksum cross-check)",
    )
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_platform_name", "cpu")
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.nprocs,
        process_id=args.pid,
    )

    import time

    if args.delay_ms:
        time.sleep(args.delay_ms / 1e3)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from swtpu.parallel import make_mesh, make_sharded_topk

    data = np.load(args.input)
    mode = str(data["mode"]) if "mode" in data else "pairs"
    q, t, ids = data["q"], data["t"], data["ids"]
    B = t.shape[0]
    n_dev = len(jax.devices())
    if args.lo >= 0:
        # ragged explicit shard (database mode): the stream path negotiates
        # the cross-host (T, R) geometry itself, so unequal row counts are
        # fine — this is the production ragged-shard scenario
        lo, hi = args.lo, args.hi
    else:
        assert B % n_dev == 0, (B, n_dev)
        shard_rows = B // args.nprocs
        lo, hi = args.pid * shard_rows, (args.pid + 1) * shard_rows

    mesh = make_mesh()
    if mode == "database":
        # the PRODUCTION multi-host path: one replicated query, this
        # process's database shard, on the stream backend (the GPU's
        # choice in the platform table; the Pallas interpreter here)
        from swtpu.parallel.multihost import score_database_multihost

        lens = data["lens"]
        # the dense (mat, lens) form end-to-end: per-shard packing takes
        # the native plan/fill path, no per-read Python objects (round-4
        # verdict: the 1->2 process efficiency gap was per-read re-slicing)
        top_s, top_ids, local_scores = score_database_multihost(
            q, (t[lo:hi], lens[lo:hi]), ids[lo:hi], mesh=mesh, k=args.topk,
            backend="stream",
        )
        local_rows = np.arange(lo, hi)
        if args.cursor:
            # per-shard completion cursor: scores + rows + checksum,
            # written atomically (tmp + rename) the moment they exist —
            # the WED job-progress field made durable
            import os as _os

            from swtpu.utils.guards import checksum as _csum

            tmp = args.cursor + ".tmp.npz"
            with open(tmp, "wb") as f:
                np.savez(
                    f, local_rows=local_rows, local_scores=local_scores,
                    checksum=_csum(np.asarray(local_scores)),
                    job_fp=args.cursor_fp,
                )
            _os.replace(tmp, args.cursor)
    else:
        sharding = NamedSharding(mesh, P("data", None))
        qg = jax.make_array_from_process_local_data(sharding, q[lo:hi])
        tg = jax.make_array_from_process_local_data(sharding, t[lo:hi])
        idsg = jax.make_array_from_process_local_data(
            NamedSharding(mesh, P("data")), ids[lo:hi]
        )

        topk = make_sharded_topk(mesh, k=args.topk)
        top_s, top_ids, scores = topk(qg, tg, idsg)
        # each process materializes the replicated top-K and its local rows
        local_scores = np.concatenate(
            [np.asarray(s.data) for s in scores.addressable_shards]
        )
        local_rows = np.concatenate(
            [np.arange(*s.index[0].indices(B)[:2]) for s in scores.addressable_shards]
        )
    from swtpu.utils.guards import checksum

    if args.adversary == "corrupt":
        # a device-boundary liar: plausible-looking wrong scores, checksum
        # computed AFTER the lie so the wire check passes — only the
        # driver's independent oracle audit can catch this
        local_scores = local_scores + 37
        csum = checksum(local_scores)
    elif args.adversary == "corrupt_wire":
        # corruption between compute and the result transfer: checksum is
        # of the true scores, payload differs — the driver's checksum
        # cross-check catches it (the odd-parity-bit analog)
        csum = checksum(local_scores)
        local_scores = local_scores ^ 0x55
    else:
        csum = checksum(local_scores)
    np.savez(
        args.output,
        top_s=np.asarray(top_s),
        top_ids=np.asarray(top_ids),
        local_scores=local_scores,
        local_rows=local_rows,
        pid=args.pid,
        checksum=csum,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
