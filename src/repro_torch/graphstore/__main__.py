"""``python -m repro_torch.graphstore``: build, inspect, partition, mutate
and compact stores.

A host tool, as the reference's ``python -m repro_torch.graphstore`` is: it reads
and writes ``.gstore`` directories with numpy and touches no device, by
design.  Stores it writes equal the reference's, byte for byte.

Examples::

    # 2^14 vertices, ~8·2^14 undirected edges, streamed to disk
    python -m repro_torch.graphstore build g14.gstore --source rmat --scale 14 \\
        --edge-factor 8 --seed 0

    # SNAP-style edge list (u v [w] per line, '#' comments)
    python -m repro_torch.graphstore build web.gstore --source tsv --input web.txt

    python -m repro_torch.graphstore info g14.gstore --json

    # shards for a (1 replica × 4 vertex-block) mesh; --ell-width also
    # writes the mesh-frontier ELL shards (row width 32)
    python -m repro_torch.graphstore partition g14.gstore --scheme 1d \\
        --replicas 1 --blocks 4 --ell-width 32

    # fold the delta log into the base CSR; shards are refreshed in place
    python -m repro_torch.graphstore append g14.gstore --add 0 5 3.0
    python -m repro_torch.graphstore compact g14.gstore --verify

Output conventions: human-readable progress goes through the
``repro_torch.graphstore`` logger on stderr (``--quiet`` silences it);
``--json`` emits one machine-readable JSON document on stdout.
``--trace out.json`` records a Chrome trace of the run (ingest, partition,
delta spans; load it in ui.perfetto.dev) and ``--metrics out.txt`` dumps
the obs registry in Prometheus text format.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs

log = logging.getLogger("repro_torch.graphstore")


def _emit(args, doc: dict) -> None:
    """One result document as JSON on stdout, under ``--json``."""
    if args.json:
        print(json.dumps(doc, indent=1, sort_keys=True))


def _cmd_build(args) -> int:
    from repro_torch.graphstore import (
        RmatEdgeSource,
        TsvEdgeSource,
        build_store,
        hub_sort_store,
        open_store,
    )

    if args.source == "rmat":
        src = RmatEdgeSource(
            args.scale,
            args.edge_factor,
            max_weight=args.max_weight,
            seed=args.seed,
            chunk_edges=args.chunk_edges,
        )
    else:
        if not args.input:
            log.error("--source tsv requires --input PATH")
            return 2
        src = TsvEdgeSource(args.input, n=args.n, chunk_edges=args.chunk_edges)
    path, stats = build_store(src, args.store)
    log.info(
        "built %s: n=%d m=%d (%d input edges, %d chunks, %.2fs, "
        "%.0f edges/s, peak chunk %.1f MiB)",
        path, stats.n, stats.m_directed, stats.edges_in, stats.chunks,
        stats.seconds, stats.edges_per_sec,
        stats.peak_chunk_bytes / 2**20,
    )
    doc = {
        "cmd": "build",
        "path": str(path),
        "n": stats.n,
        "m_directed": stats.m_directed,
        "edges_in": stats.edges_in,
        "chunks": stats.chunks,
        "seconds": round(stats.seconds, 3),
        "edges_per_sec": round(stats.edges_per_sec, 1),
        "peak_chunk_bytes": stats.peak_chunk_bytes,
        "fixed_bytes": stats.fixed_bytes,
    }
    if args.hub_sort:
        store = open_store(path, verify=False)
        out = str(path).replace(".gstore", "") + ".hub.gstore"
        hpath, _ = hub_sort_store(store, out)
        log.info("hub-sorted copy: %s", hpath)
        doc["hub_sorted"] = str(hpath)
    _emit(args, doc)
    return 0


def _cmd_info(args) -> int:
    from repro_torch.graphstore import open_store

    store = open_store(args.store, verify=args.verify)
    mf = store.manifest
    deg = store.degrees()
    part = store.partition_meta
    doc = {
        "cmd": "info",
        "path": str(store.path),
        "format_version": mf["format_version"],
        "n": int(store.n),
        "m_directed": int(store.m),
        "weight_range": mf.get("weight_range"),
        "degree": {
            "min": int(deg.min()),
            "median": int(np.median(deg)),
            "max": int(deg.max()),
        },
        "source": mf.get("source"),
        "reorder": mf.get("reorder", None),
        "partition": part or None,
        "checksums_verified": bool(args.verify),
    }
    if args.json:
        _emit(args, doc)
        return 0
    print(f"{store.path}")
    print(f"  format_version : {mf['format_version']}")
    print(f"  n              : {store.n:,}")
    print(f"  m (directed)   : {store.m:,}")
    print(f"  weight range   : {mf.get('weight_range')}")
    print(f"  degree min/med/max : {deg.min()} / {int(np.median(deg))} / {deg.max()}")
    print(f"  source         : {mf.get('source')}")
    print(f"  reorder        : {mf.get('reorder', None)}")
    if part:
        counts = np.asarray(part["counts"])
        print(
            f"  partition      : {part['scheme']} "
            f"{json.dumps({k: v for k, v in part.items() if k != 'counts'})}"
        )
        print(
            f"  shard edges    : min={counts.min():,} max={counts.max():,} "
            f"(balance {counts.max() / max(1, counts.min()):.2f}x)"
        )
    else:
        print("  partition      : none")
    print(f"  checksums      : {'verified' if args.verify else 'skipped'}")
    return 0


def _cmd_partition(args) -> int:
    from repro_torch.graphstore import (
        open_store,
        partition_ell_store,
        partition_store,
        partition_store_2d,
    )

    store = open_store(args.store, verify=False)
    if args.scheme == "1d":
        meta = partition_store(
            store, n_replica=args.replicas, n_blocks=args.blocks
        )
    else:
        if args.ell_width is not None:
            log.error("--ell-width requires --scheme 1d")
            return 2
        meta = partition_store_2d(store, R=args.rows, C=args.cols)
    counts = np.asarray(meta["counts"])
    log.info(
        "partitioned %s [%s]: %d shards, edges/shard min=%d max=%d",
        store.path, meta["scheme"], counts.size, counts.min(), counts.max(),
    )
    doc = {
        "cmd": "partition",
        "path": str(store.path),
        "meta": {k: v for k, v in meta.items() if k != "counts"},
        "shards": int(counts.size),
        "edges_per_shard": {"min": int(counts.min()), "max": int(counts.max())},
    }
    if args.scheme == "1d" and args.ell_width is not None:
        ell = partition_ell_store(store, k=args.ell_width)
        ec = np.asarray(ell["counts"])
        log.info(
            "ELL shards [k=%d]: rows/shard min=%d max=%d "
            "(mesh frontier mode loads these off disk)",
            ell["k"], ec.min(), ec.max(),
        )
        doc["ell"] = {
            "k": int(ell["k"]),
            "rows_per_shard": {"min": int(ec.min()), "max": int(ec.max())},
        }
    _emit(args, doc)
    return 0


def _cmd_append(args) -> int:
    from repro_torch.graphstore import append_deltas

    records = []
    if args.records:
        with open(args.records) as h:
            for rec in json.load(h):
                records.append(tuple(rec))
    for u, v, w in args.add or ():
        records.append(("add", int(u), int(v), float(w)))
    for u, v in args.delete or ():
        records.append(("delete", int(u), int(v)))
    for u, v, w in args.reweight or ():
        records.append(("reweight", int(u), int(v), float(w)))
    if not records:
        log.error(
            "no delta records: pass --records FILE and/or "
            "--add/--delete/--reweight"
        )
        return 2
    info = append_deltas(args.store, records, map_ids=not args.raw_ids)
    log.info(
        "appended %s: %d records -> epoch %d",
        info["file"], info["count"], info["epoch"],
    )
    _emit(args, {"cmd": "append", "path": args.store, **info})
    return 0


def _cmd_compact(args) -> int:
    from repro_torch.graphstore import compact

    stats = compact(args.store, verify=args.verify)
    log.info(
        "compacted %s: epoch %d, %d segments (%d records) folded, "
        "m %d -> %d, shards %d/%d rewritten, %.2fs",
        args.store, stats.epoch, stats.segments_folded,
        stats.records_folded, stats.m_before, stats.m_after,
        stats.shard_files_rewritten, stats.shard_files_total,
        stats.seconds,
    )
    _emit(args, {
        "cmd": "compact",
        "path": args.store,
        "epoch": stats.epoch,
        "segments_folded": stats.segments_folded,
        "records_folded": stats.records_folded,
        "m_before": stats.m_before,
        "m_after": stats.m_after,
        "scheme": stats.scheme,
        "shard_files_total": stats.shard_files_total,
        "shard_files_rewritten": stats.shard_files_rewritten,
        "seconds": round(stats.seconds, 3),
    })
    return 0


def _cmd_verify(args) -> int:
    """Re-streams every array and delta-segment CRC; exit 1 on mismatch."""
    from repro_torch.graphstore import verify_store
    from repro_torch.graphstore.format import read_manifest

    mf = read_manifest(args.store)
    try:
        verify_store(args.store, mf)
    except Exception as e:
        log.error("verify FAILED: %s", e)
        _emit(args, {
            "cmd": "verify", "path": args.store, "ok": False,
            "error": str(e),
        })
        return 1
    n_arrays = len(mf["arrays"])
    n_deltas = len(mf.get("deltas", ()))
    log.info(
        "verified %s: %d arrays + %d delta segments OK (epoch %d)",
        args.store, n_arrays, n_deltas, int(mf.get("epoch", 0)),
    )
    _emit(args, {
        "cmd": "verify", "path": args.store, "ok": True,
        "arrays": n_arrays, "delta_segments": n_deltas,
        "epoch": int(mf.get("epoch", 0)),
    })
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.graphstore",
        description="Out-of-core .gstore graph storage utilities.",
    )
    ap.add_argument(
        "--json", action="store_true",
        help="emit one machine-readable JSON document on stdout",
    )
    ap.add_argument(
        "--quiet", action="store_true",
        help="suppress progress logging (stderr)",
    )
    ap.add_argument(
        "--trace", metavar="PATH", default=None,
        help="record a Chrome trace of this run (Perfetto-loadable)",
    )
    ap.add_argument(
        "--metrics", metavar="PATH", default=None,
        help="dump obs metrics in Prometheus text format",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="stream an edge source into a .gstore")
    b.add_argument("store", help="output .gstore directory")
    b.add_argument("--source", choices=("rmat", "tsv"), default="rmat")
    b.add_argument("--scale", type=int, default=14, help="RMAT n = 2^scale")
    b.add_argument("--edge-factor", type=int, default=8)
    b.add_argument("--max-weight", type=int, default=100)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--input", help="edge-list file for --source tsv")
    b.add_argument("--n", type=int, default=None, help="vertex count (tsv)")
    b.add_argument("--chunk-edges", type=int, default=1 << 16)
    b.add_argument(
        "--hub-sort", action="store_true",
        help="also write a degree-descending-reordered copy (*.hub.gstore)",
    )
    b.set_defaults(fn=_cmd_build)

    i = sub.add_parser("info", help="print a store's manifest summary")
    i.add_argument("store")
    i.add_argument("--no-verify", dest="verify", action="store_false",
                   help="skip checksum verification")
    i.set_defaults(fn=_cmd_info, verify=True)

    p = sub.add_parser("partition", help="write per-device shards")
    p.add_argument("store")
    p.add_argument("--scheme", choices=("1d", "2d"), default="1d")
    p.add_argument("--replicas", type=int, default=1, help="1d: replica rows")
    p.add_argument("--blocks", type=int, default=4, help="1d: vertex blocks")
    p.add_argument("--rows", type=int, default=2, help="2d: src-block rows")
    p.add_argument("--cols", type=int, default=2, help="2d: dst-block cols")
    p.add_argument(
        "--ell-width", type=int, default=None, metavar="K",
        help="1d: also write source-block ELL shards of row width K "
             "(the mesh frontier mode's on-disk priority-queue layout)",
    )
    p.set_defaults(fn=_cmd_partition)

    a = sub.add_parser(
        "append", help="append edge deltas as one crash-safe log segment"
    )
    a.add_argument("store")
    a.add_argument(
        "--records", metavar="FILE",
        help='JSON list of records: [["add",u,v,w], ["delete",u,v], '
             '["reweight",u,v,w], ...]',
    )
    a.add_argument(
        "--add", nargs=3, action="append", metavar=("U", "V", "W"),
        help="add one undirected edge (repeatable)",
    )
    a.add_argument(
        "--delete", nargs=2, action="append", metavar=("U", "V"),
        help="delete every live u-v edge (repeatable)",
    )
    a.add_argument(
        "--reweight", nargs=3, action="append", metavar=("U", "V", "W"),
        help="set the weight of every live u-v edge (repeatable)",
    )
    a.add_argument(
        "--raw-ids", action="store_true",
        help="endpoints are already in stored-id space (skip vertex_perm)",
    )
    a.set_defaults(fn=_cmd_append)

    c = sub.add_parser(
        "compact",
        help="fold the delta log into a fresh base store (atomic; "
             "persisted shards are maintained incrementally)",
    )
    c.add_argument("store")
    c.add_argument(
        "--verify", action="store_true",
        help="re-stream checksums of the compacted store before returning",
    )
    c.set_defaults(fn=_cmd_compact)

    v = sub.add_parser(
        "verify",
        help="re-stream every array + delta segment CRC; exit 1 on mismatch",
    )
    v.add_argument("store")
    v.set_defaults(fn=_cmd_verify)

    args = ap.parse_args(argv)
    # (re)bind the package logger per invocation: progress goes to the
    # current stderr (not stdout, which --json owns), and --quiet drops it
    # to WARNING
    log.handlers.clear()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.WARNING if args.quiet else logging.INFO)
    log.propagate = False
    if args.trace or args.metrics:
        obs.enable(trace=args.trace is not None,
                   metrics=args.metrics is not None)
    rc = args.fn(args)
    if args.trace:
        obs.export_chrome_trace(args.trace)
        log.info("trace written: %s", args.trace)
    if args.metrics:
        with open(args.metrics, "w") as h:
            h.write(obs.prometheus_text())
        log.info("metrics written: %s", args.metrics)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
