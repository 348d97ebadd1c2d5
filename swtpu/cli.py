"""swtpu command-line host runtime.

The replacement of the reference's C host program
(capi_sample_aligner/software-C,C++/src/main_test.c:33-42:
``./main_test -q query_file -l library_file -t timeout``), generalized to
whole databases (the ScoreBank workload) instead of one pair:

    swtpu score  -q query.fa -l library.fa [-o out.txt] [--topk K]
    swtpu serve  -l library.fa                      # stdin daemon (SEQ/TOP/QUIT)
    swtpu oracle -q query.fa -l library.fa          # numpy oracle (no JAX)
    swtpu generate -n 100 -L 128 -o data.fa         # random FASTA (data/generate.py)
    swtpu diff / events / regress / bench           # goldens, logs, suites

Output format matches the RTL testbench's golden lines
(``@<time>ns: >dbK score: S``, ScoreBank/ScoreBank_v1_tb.sv:280-282) so
outputs diff directly against the reference's `data/*_out.txt`.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional


def _load(query_path: str, library_path: str):
    """Load query + library through the dense native pipeline (the analog of
    the C host's read_sequences+charTo2bit, main_test.c:290-314): the library
    stays one int8 matrix end-to-end, no per-read Python objects."""
    import numpy as np

    from swtpu.io.loader import EncodedDB, load_encoded

    qdb = load_encoded(query_path)
    if not qdb.names:
        raise SystemExit(f"query file has no records: {query_path}")
    qidx = [i for i, nm in enumerate(qdb.names) if nm.startswith("query")] or [0]
    query = qdb.read(qidx[0]).copy()
    lib = load_encoded(library_path)
    return query, *_split_lib(lib)


def _split_lib(lib):
    import numpy as np

    from swtpu.io.loader import EncodedDB
    rows = [i for i, nm in enumerate(lib.names) if not nm.startswith("query")]
    if len(rows) == len(lib.names):
        db = lib  # no >query record to exclude
    else:
        sel = np.asarray(rows, dtype=np.int64)
        db = EncodedDB(
            [lib.names[i] for i in rows], lib.mat[sel], lib.lens[sel]
        )
    return db.names, db


def _load_all_queries(query_path: str):
    """Every record of the query FASTA as (name, codes) pairs."""
    from swtpu.io.loader import load_encoded

    qdb = load_encoded(query_path)
    if not qdb.names:
        raise SystemExit(f"query file has no records: {query_path}")
    return [(qdb.names[i], qdb.read(i).copy()) for i in range(len(qdb.names))]


def _emit(out, names, scores, t_start):
    from swtpu.server import format_score_line

    for name, s in zip(names, scores):
        ns = int((time.perf_counter() - t_start) * 1e9)
        out.write(format_score_line(name, s, ns) + "\n")


def cmd_score(args) -> int:
    from swtpu.bank import ScoreBank
    from swtpu.config import Penalties, SWConfig

    if args.score_width and not 2 <= args.score_width <= 30:
        # fail like every other CLI argument error (clean SystemExit, not a
        # kernel ValueError traceback)
        raise SystemExit(
            f"--score-width must be 2..30 (got {args.score_width})"
        )
    pen = Penalties(args.match, args.mismatch, args.gap_open, args.gap_extend)
    query, names, targets = _load(args.query, args.library)
    max_len = max((len(t) for t in targets), default=0)
    try:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints: {args.buckets!r}")
    cfg = SWConfig(
        penalties=pen,
        target_buckets=buckets,
        score_width=args.score_width or None,
    )
    bank = ScoreBank(cfg, backend=args.backend)
    all_queries = getattr(args, "all_queries", False)
    if all_queries:
        if args.resume or args.timeout:
            raise SystemExit(
                "--all-queries does not compose with --resume/--timeout "
                "(each query is one short job; rerun is the restart unit)"
            )
        qpairs = _load_all_queries(args.query)
        qlen_max = max((len(q) for _, q in qpairs), default=0)
    else:
        qpairs = None
        qlen_max = len(query)
    # capacity ladder: the stream backend's target axis is unbounded by
    # design (reads concatenate along a stream) — a 20-kb read sails
    # through the front door (the reference's TARGET_LENGTH cap,
    # ScoreBank_v2.v:16, is NOT re-imposed voluntarily).  Bucketed backends
    # still fail cleanly at the front door, never with a mid-run packer
    # traceback.
    ladder_applies = bank.backend != "stream"
    if ladder_applies and max_len > buckets[-1]:
        raise SystemExit(
            f"read length {max_len} exceeds bucket capacity {buckets[-1]} "
            f"for this configuration (raise --buckets, or use the stream "
            "backend)"
        )
    event_log = None
    if args.events:
        from swtpu.utils import EventLog

        event_log = EventLog(args.events)
    if all_queries:
        from swtpu.utils import profile_trace

        with profile_trace(args.profile):
            rc = _score_all_queries(args, bank, names, targets, qpairs,
                                    event_log)
        if event_log is not None:
            event_log.close()
        return rc
    t0 = time.perf_counter()
    from swtpu.utils import profile_trace

    def _run():
        if args.resume:
            from swtpu.bank.resume import score_database_resumable

            return score_database_resumable(bank, query, targets, args.resume)
        return bank.score_database(query, targets, event_log=event_log)

    with profile_trace(args.profile):
        if args.timeout > 0:
            # hard job deadline, the analog of main_test.c's WED-status poll
            # timeout (main_test.c:434-445): report and exit non-zero instead
            # of hanging on a wedged device
            import threading

            box = {}

            def _work():
                try:
                    box["res"] = _run()
                except Exception as e:  # pragma: no cover
                    box["err"] = e

            th = threading.Thread(target=_work, daemon=True)
            th.start()
            th.join(timeout=args.timeout)
            if "err" in box:
                raise box["err"]
            if "res" not in box:
                print(f"# TIMEOUT after {args.timeout}s", file=sys.stderr)
                if event_log is not None:
                    event_log.close()
                return 16  # mirrors the reference's timeout error path
            res = box["res"]
        else:
            res = _run()
    if event_log is not None:
        event_log.close()
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        _emit(out, names, res.scores, t0)
    finally:
        if args.output:
            out.close()
    print(
        f"# {len(targets)} reads, {res.cells} cells in {res.elapsed_s*1e3:.1f} ms "
        f"-> {res.gcups:.2f} GCUPS (pad efficiency "
        f"{res.cells/max(res.padded_cells,1):.1%})",
        file=sys.stderr,
    )
    if args.topk:
        for s, i in res.top_k(args.topk):
            print(f"# top: >{names[i]} score: {s}", file=sys.stderr)
    return 0


def _score_all_queries(args, bank, names, targets, pairs, event_log=None) -> int:
    """Score EVERY query record against the library.  On the stream
    backend the database loads onto the device once (ScoreBank
    .load_database) and each query ships only its register — the
    many-queries serving pattern; bucketed backends loop score_database."""
    t0 = time.perf_counter()
    # the loaded-database fast path serves every stream-backend workload,
    # score_width and any query length included
    use_loaded = bank.backend == "stream"
    if use_loaded:
        db = bank.load_database(targets)

        # pipelined waves: every query in a wave is dispatched before any
        # result materializes (score_loaded_many); waves bound host memory
        # to WAVE * n_reads * 4 B of scores
        WAVE = 32

        def run_all():
            for lo in range(0, len(pairs), WAVE):
                chunk = pairs[lo : lo + WAVE]
                for (name, _), res in zip(
                    chunk,
                    bank.score_loaded_many([q for _, q in chunk], db),
                ):
                    yield name, res
    else:
        def run_all():
            for name, q in pairs:
                yield name, bank.score_database(q, targets)
    out = open(args.output, "w") if args.output else sys.stdout
    tot_cells = 0
    tot_s = 0.0
    try:
        for (name, q), (_, res) in zip(pairs, run_all()):
            out.write(f"# query: {name}\n")
            _emit(out, names, res.scores, t0)
            tot_cells += res.cells
            tot_s += res.elapsed_s
            if event_log is not None:
                from swtpu.utils import BatchEvent

                event_log.emit(
                    BatchEvent(
                        "query", t_wall=time.time(), elapsed_s=res.elapsed_s,
                        reads=len(targets), cells=res.cells,
                        padded_cells=res.padded_cells, note=f"query={name}",
                    )
                )
            if args.topk:
                for s, i in res.top_k(args.topk):
                    print(f"# top[{name}]: >{names[i]} score: {s}", file=sys.stderr)
    finally:
        if args.output:
            out.close()
    print(
        f"# {len(pairs)} queries x {len(targets)} reads, {tot_cells} cells "
        f"in {tot_s*1e3:.1f} ms -> {tot_cells/max(tot_s,1e-9)/1e9:.2f} GCUPS",
        file=sys.stderr,
    )
    return 0


def cmd_serve(args) -> int:
    """Interactive serving loop: load the library once (device-resident on
    the stream backend), then score queries from stdin until EOF — the long-lived host
    process the reference's WED work queue implies (main_test.c loops one
    job; a serving daemon loops many).

    Protocol (line-oriented, scriptable):
      SEQ <bases>   score a raw sequence (ACGT...)
      TOP <k> <bases>  report only the best k hits (on-device top-K cut)
      QUIT          exit
    Responses: one `@..ns: >name score: S` block per SEQ (like `score`),
    or `# top: >name score: S` lines per TOP; errors print `# error: ...`
    and the loop continues."""
    from swtpu.bank import ScoreBank
    from swtpu.config import Penalties, SWConfig
    from swtpu.io.loader import load_encoded

    pen = Penalties(args.match, args.mismatch, args.gap_open, args.gap_extend)
    names, targets = _split_lib(load_encoded(args.library))
    cfg = SWConfig(penalties=pen)
    bank = ScoreBank(cfg, backend=args.backend)
    event_log = None
    if getattr(args, "events", None):
        from swtpu.utils import EventLog

        event_log = EventLog(args.events)
    use_loaded = bank.backend == "stream"
    db = None
    if use_loaded:
        t0 = time.perf_counter()
        if getattr(args, "sharded", False):
            # mesh-resident serving: every visible device holds its shard
            # (the MODULES-axis deployment; swtpu/bank/serving.py)
            from swtpu.parallel import make_mesh

            mesh = make_mesh()
            db = bank.load_database_sharded(targets, mesh)
            print(
                f"# loaded {db.n_reads} reads across {db.n_shards} device "
                f"shards in {time.perf_counter()-t0:.2f}s (mesh-resident)",
                file=sys.stderr,
            )
        else:
            db = bank.load_database(targets)
            print(
                f"# loaded {len(targets)} reads in "
                f"{time.perf_counter()-t0:.2f}s (device-resident)",
                file=sys.stderr,
            )
    elif getattr(args, "sharded", False):
        raise SystemExit("--sharded requires the stream backend")
    else:
        print(f"# serving {len(targets)} reads ({bank.backend})", file=sys.stderr)
    from swtpu.server import ServeEngine, serve_socket

    engine = ServeEngine(
        bank, names, targets, db=db if use_loaded else None,
        event_log=event_log,
    )
    use_socket = getattr(args, "socket", None)
    use_port = getattr(args, "port", None)
    if use_socket and use_port is not None:
        raise SystemExit("--socket and --port are mutually exclusive")
    if use_socket or use_port is not None:
        # multi-client daemon (the PSLSE multi-context analog): any number
        # of concurrent clients, one in-flight job each, device dispatch
        # serialized by the engine lock (swtpu/server.py)
        where = use_socket or f"127.0.0.1:{use_port}"
        print(f"# serving on {where} (concurrent clients; SEQ/TOP/QUIT, "
              "responses end with '.')", file=sys.stderr)
        try:
            serve_socket(engine, unix_path=use_socket or None, port=use_port)
        except KeyboardInterrupt:
            pass
        finally:
            if event_log is not None:
                event_log.close()
        print(f"# served {engine.served} queries", file=sys.stderr)
        return 0
    inp = open(args.input) if args.input else sys.stdin
    try:
        for line in inp:
            resp = engine.handle(line)
            if resp is None:  # QUIT
                break
            for out_line in resp:
                print(out_line)
            if resp:
                sys.stdout.flush()
    finally:
        if args.input:
            inp.close()
        if event_log is not None:
            event_log.close()
    print(f"# served {engine.served} queries", file=sys.stderr)
    return 0


def cmd_oracle(args) -> int:
    from swtpu.config import Penalties
    from swtpu.oracle import score_many_vs_one

    pen = Penalties(args.match, args.mismatch, args.gap_open, args.gap_extend)
    query, names, targets = _load(args.query, args.library)
    t0 = time.perf_counter()
    scores = score_many_vs_one(query, targets, pen)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        _emit(out, names, scores, t0)
    finally:
        if args.output:
            out.close()
    return 0


def cmd_generate(args) -> int:
    """Random FASTA generator (the analog of data/generate.py: first record
    `>query`, rest `>dbK`)."""
    import numpy as np

    from swtpu.io import FastaRecord, write_fasta
    from swtpu.io.encode import CODE_BASES

    rng = np.random.default_rng(args.seed)
    records: List[FastaRecord] = []
    for j in range(args.number):
        codes = rng.integers(0, 4, size=args.length)
        seq = "".join(CODE_BASES[int(c)] for c in codes)
        records.append(FastaRecord("query" if j == 0 else f"db{j}", seq))
    write_fasta(args.output, records)
    print(f"# wrote {args.number} reads x {args.length} nt to {args.output}", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    import bench  # bench.py at the checkout root

    return bench.main([])


def cmd_diff(args) -> int:
    """Diff two score files (either `@..ns: >dbK score: S` RTL format or
    ssearch36 -R tables) — the reference's offline golden-diff methodology
    (SURVEY.md §4: scores logged and diffed against oracles)."""
    from swtpu.testing.goldens import parse_rtl_out_file, parse_ssearch_scores

    def load(path):
        got = parse_rtl_out_file(path)
        return got if got else parse_ssearch_scores(path)

    a, b = load(args.a), load(args.b)
    common = sorted(set(a) & set(b))
    mism = {k: (a[k], b[k]) for k in common if a[k] != b[k]}
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    print(f"# {len(common)} common IDs, {len(mism)} mismatches, "
          f"{len(only_a)} only in A, {len(only_b)} only in B")
    for k, (va, vb) in sorted(mism.items()):
        print(f"MISMATCH {k}: {va} != {vb}")
    return 1 if mism else 0


def cmd_events(args) -> int:
    """Pretty-print a JSONL event log (the offline parser for swtpu's
    debug.log analog — reference: pslse-master/debug/main.c:52-218)."""
    from swtpu.utils import EventLog

    events = EventLog.parse(args.log)
    tot_cells = tot_reads = 0
    tot_s = 0.0
    for e in events:
        pad_eff = f"{e.cells/e.padded_cells:6.1%}" if e.padded_cells else "   n/a"
        print(
            f"{e.t_wall:14.3f} {e.kind:>8} reads={e.reads:<8} "
            f"cells={e.cells:<12} pad_eff={pad_eff} "
            f"{e.elapsed_s*1e3:9.2f} ms {e.gcups:8.2f} GCUPS {e.note}"
        )
        tot_cells += e.cells
        tot_reads += e.reads
        tot_s += e.elapsed_s
    if tot_s > 0:
        print(
            f"# total: {len(events)} events, {tot_reads} reads, "
            f"{tot_cells} cells in {tot_s*1e3:.1f} ms "
            f"-> {tot_cells/tot_s/1e9:.2f} GCUPS"
        )
    return 0


def _add_pen_args(p):
    p.add_argument("--match", type=int, default=5)
    p.add_argument("--mismatch", type=int, default=-4)
    p.add_argument("--gap-open", dest="gap_open", type=int, default=-12)
    p.add_argument("--gap-extend", dest="gap_extend", type=int, default=-4)


def _select_platform(name: str) -> None:
    """Pin the JAX platform before any backend initializes.  Needed because
    some environments pre-import jax at interpreter start, after which
    JAX_PLATFORMS is ignored (config.update still works).  The scoring
    kernel then follows the platform table (swtpu.device)."""
    if name == "auto":
        return
    import jax

    jax.config.update("jax_platforms", "cuda" if name == "gpu" else name)
    try:
        jax.config.update("jax_platform_name", name)
    except Exception:
        pass


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="swtpu", description=__doc__)
    ap.add_argument(
        "--platform",
        default="auto",
        choices=["auto", "cpu", "gpu"],
        help="pin the JAX platform (default: JAX's own choice)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("score", help="score a library against a query")
    ps.add_argument("-q", "--query", required=True)
    ps.add_argument("-l", "--library", required=True)
    ps.add_argument("-o", "--output")
    ps.add_argument(
        "-t", "--timeout", type=int, default=0,
        help="hard job deadline in seconds; exit 16 on expiry "
        "(main_test.c's WED-poll timeout, main_test.c:434-445). 0 = none",
    )
    ps.add_argument("--topk", type=int, default=0)
    ps.add_argument("--backend", default="auto", choices=["auto", "scan", "stream"])
    ps.add_argument(
        "--score-width", dest="score_width", type=int, default=0,
        help="emulate the RTL's SCORE_WIDTH-bit biased registers, including "
        "overflow wrap (0 = exact int32 scoring; the hardware default is 12)",
    )
    ps.add_argument(
        "--all-queries", dest="all_queries", action="store_true",
        help="score EVERY query-file record against the library (stream "
        "backend: the database loads onto the device once and each query "
        "ships only its register)",
    )
    ps.add_argument(
        "--buckets", default="32,128,512,2048,8192",
        help="target-length bucket ladder for the bucketed backends "
        "(SWConfig.target_buckets); the stream backend ignores it — its "
        "target axis is unbounded",
    )
    ps.add_argument("--events", help="write per-batch JSONL event log here")
    ps.add_argument("--profile", help="write a jax.profiler trace to this dir")
    ps.add_argument("--resume", help="resumable job state file (WED analog)")
    _add_pen_args(ps)
    ps.set_defaults(fn=cmd_score)

    po = sub.add_parser("oracle", help="score with the numpy oracle (no JAX)")
    po.add_argument("-q", "--query", required=True)
    po.add_argument("-l", "--library", required=True)
    po.add_argument("-o", "--output")
    _add_pen_args(po)
    po.set_defaults(fn=cmd_oracle)

    pg = sub.add_parser("generate", help="generate a random FASTA")
    pg.add_argument("-n", "--number", type=int, default=100)
    pg.add_argument("-L", "--length", type=int, default=128)
    pg.add_argument("-o", "--output", required=True)
    pg.add_argument("--seed", type=int, default=0)
    pg.set_defaults(fn=cmd_generate)

    pv = sub.add_parser(
        "serve",
        help="load a library once (device-resident) and score "
        "queries from stdin (SEQ/TOP/QUIT protocol)",
    )
    pv.add_argument("-l", "--library", required=True)
    pv.add_argument("--input", help="read commands from a file instead of stdin")
    pv.add_argument("--backend", default="auto", choices=["auto", "scan", "stream"])
    pv.add_argument(
        "--events", help="write per-query JSONL event log here "
        "(summarize with `swtpu events`)",
    )
    pv.add_argument(
        "--sharded", action="store_true",
        help="hold the library resident across ALL visible devices "
        "(mesh-sharded serving; queries broadcast, top-K merges "
        "collectively)",
    )
    pv.add_argument(
        "--socket", help="serve concurrent clients on this UNIX socket "
        "path instead of stdin (PSLSE multi-context analog)",
    )
    pv.add_argument(
        "--port", type=int, help="serve concurrent clients on this "
        "localhost TCP port instead of stdin",
    )
    _add_pen_args(pv)
    pv.set_defaults(fn=cmd_serve)

    pb = sub.add_parser(
        "bench", help="time the main scoring path on the GPU (bench.py)"
    )
    pb.set_defaults(fn=cmd_bench)

    pd = sub.add_parser("diff", help="diff two score files by read ID")
    pd.add_argument("a")
    pd.add_argument("b")
    pd.set_defaults(fn=cmd_diff)

    pe = sub.add_parser("events", help="pretty-print a JSONL event log")
    pe.add_argument("log")
    pe.set_defaults(fn=cmd_events)

    pr = sub.add_parser("regress", help="run a config-driven regression suite")
    pr.add_argument("--suite", help="JSON suite file (defaults built in)")
    pr.set_defaults(fn=lambda a: __import__(
        "swtpu.testing.suite", fromlist=["main_cli"]
    ).main_cli(a.suite))

    args = ap.parse_args(argv)
    _select_platform(args.platform)
    from swtpu.device import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
