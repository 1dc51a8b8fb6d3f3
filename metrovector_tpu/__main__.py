"""Command-line inspector for MVT files: ``python -m metrovector_tpu``.

Storage-layer tooling the reference leaves to code (its only runnable
surfaces are the examples); everything here is host-side and jax-free
except ``search``, which runs the XLA exact path on whatever backend JAX
picks (CPU works).

Commands::

    python -m metrovector_tpu info FILE            # spaces, blocks, stats
    python -m metrovector_tpu validate FILE        # structure [+ CRC]
    python -m metrovector_tpu head FILE [-s SPACE] [-n 5]
    python -m metrovector_tpu search FILE -q Q.npy [-s SPACE] [-k 10]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _human(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


def _open(path):
    from .format.reader import Reader

    return Reader.open(path)


def _pick_space(r, name: str | None) -> str:
    names = r.vector_space_names
    if name is not None:
        if name not in names:
            sys.exit(f"error: no space {name!r}; file has {names}")
        return name
    if len(names) != 1:
        sys.exit(f"error: file has {len(names)} spaces; pass -s one of {names}")
    return names[0]


def cmd_info(args) -> int:
    r = _open(args.file)
    print(f"{args.file}: MVT v{r.version}, {_human(r.file_size)}, "
          f"{r.num_vector_spaces} space(s)")
    for name in r.vector_space_names:
        sp = r.vector_space(name)
        info = sp.info
        line = (f"  {name}: {sp.num_vectors} x {sp.dim} "
                f"{sp.dtype.name.lower()} {sp.vector_type.name.lower()}, "
                f"metric={sp.metric.name.lower()}")
        q = sp.quantization
        if q is not None:
            line += f", quant(scale={q.scale:.6g}, zero={q.zero_point:.6g})"
        print(line)
        cols = sp.metadata_column_names()
        if cols:
            print(f"    metadata: {', '.join(cols)}")
        if sp.ids() is not None:
            print("    stable u64 ids: yes")
        mask = sp.tombstone_mask()
        if mask is not None:
            print(f"    tombstones: {int(mask.sum())} deleted")
        feats = []
        from .format.constants import IndexKind

        if info.index.kind != IndexKind.NONE:
            feats.append(info.index.kind.name.lower())
        if info.pq is not None:
            pq = info.pq
            feats.append(
                "pq(residual)" if getattr(pq, "residual", False) else "pq"
            )
            if getattr(pq, "packed4", False):
                feats[-1] += "+4bit"
        if feats:
            print(f"    indexes: {', '.join(feats)}")
    if r.extension_names():
        print(f"  extensions: {', '.join(r.extension_names())}")
    stats = r.stats
    if stats:
        print(f"  stats: {json.dumps(stats, default=str)}")
    return 0


def cmd_validate(args) -> int:
    r = _open(args.file)
    try:
        if args.checksum:
            r.validate_with_checksum()
        else:
            r.validate()
    except Exception as exc:  # surface the typed error message verbatim
        print(f"INVALID: {type(exc).__name__}: {exc}")
        return 1
    print("OK" + (" (checksums verified)" if args.checksum else ""))
    return 0


def cmd_head(args) -> int:
    r = _open(args.file)
    sp = r.vector_space(_pick_space(r, args.space))
    n = min(args.n, sp.num_vectors)
    np.set_printoptions(precision=4, suppress=True, threshold=16)
    for i in range(n):
        v = sp.get_vector(i)
        if sp.is_sparse:
            print(f"[{i}] nnz={v.nnz}")
        else:
            print(f"[{i}] {v.as_f32()}")
    return 0


def cmd_search(args) -> int:
    from .utils import enable_compilation_cache

    enable_compilation_cache()  # repeat CLI searches skip recompiles
    r = _open(args.file)
    name = _pick_space(r, args.space)
    sp = r.vector_space(name)
    q = np.load(args.query)
    if q.ndim == 1:
        q = q[None]
    if sp.is_sparse:
        from .sparse import SparseSearchEngine

        eng = SparseSearchEngine(sp)
    else:
        from .engine import SearchEngine

        eng = SearchEngine(sp)
    res = eng.search(q.astype(np.float32), k=args.k)
    for qi in range(q.shape[0]):
        rows = [
            {"row": int(i), "id": int(res.ids[qi, j]),
             "distance": float(res.distances[qi, j])}
            for j, i in enumerate(res.indices[qi]) if i >= 0
        ]
        print(json.dumps({"query": qi, "results": rows}))
    return 0


def cmd_tune(args) -> int:
    """Single-launch-time candidate scan ``block_rows`` for one space and
    print the report (fastest first) as JSON lines; see
    ``SearchEngine.autotune``. Routes to the right scan family: dense
    brute-force by default, the ELL sparse
    engine for sparse spaces, the persisted PQ/IVF-PQ ADC scan with
    ``--index``. ``--save`` persists the winner into the file's
    PerformanceHints so future opens adopt it."""
    from .utils import enable_compilation_cache

    enable_compilation_cache()
    r = _open(args.file)
    name = _pick_space(r, args.space)
    sp = r.vector_space(name)
    kw = {"persist": bool(args.save)}
    if args.block_rows:
        kw["block_rows_candidates"] = [int(b) for b in args.block_rows.split(",")]
    if sp.is_sparse:
        from .sparse import SparseSearchEngine

        eng = SparseSearchEngine(sp)
        report = eng.autotune(k=args.k, batch=args.batch, **kw)
        applied = {"block_rows": eng.block_rows}
    elif args.index:
        from .database import Database

        db = Database(r)
        kind = db.index_kind(name)
        if kind == "pq":
            idx = db.pq_index(name)
        elif kind == "ivfpq":
            idx = db.ivfpq_index(name)
        else:
            print(
                f"error: --index tunes PQ/IVF-PQ ADC scans; space {name!r} "
                f"persists {kind or 'no'} index sidecar",
                file=sys.stderr,
            )
            return 1
        report = idx.autotune(k=args.k, batch=args.batch, **kw)
        applied = {
            "block_rows": idx.adc_block_rows if kind == "pq"
            else idx.scan_block_rows
        }
    else:
        from .engine import SearchEngine

        eng = SearchEngine(sp)
        report = eng.autotune(k=args.k, batch=args.batch, **kw)
        applied = {"block_rows": eng.block_rows}
    for row in report:
        print(json.dumps(row))
    if report and np.isfinite(report[0]["ms"]):
        print(json.dumps(
            {"applied": applied, "saved": bool(args.save)}
        ))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m metrovector_tpu",
        description="Inspect and query MVT vector files.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="file and per-space summary")
    p.add_argument("file")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("validate", help="structural validation")
    p.add_argument("file")
    p.add_argument("--checksum", action="store_true",
                   help="also recompute per-block CRC32 (reads all bytes)")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("head", help="print the first vectors")
    p.add_argument("file")
    p.add_argument("-s", "--space", default=None)
    p.add_argument("-n", type=int, default=5)
    p.set_defaults(fn=cmd_head)

    p = sub.add_parser("search", help="exact top-k for queries in a .npy")
    p.add_argument("file")
    p.add_argument("-q", "--query", required=True,
                   help="path to a [Q, dim] (or [dim]) .npy float array")
    p.add_argument("-s", "--space", default=None)
    p.add_argument("-k", type=int, default=10)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser(
        "tune", help="single-launch-time scan tilings for a space"
    )
    p.add_argument("file")
    p.add_argument("-s", "--space", default=None)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--batch", type=int, default=128,
                   help="sample query batch size (default 128)")
    p.add_argument("--block-rows", default=None,
                   help="comma-separated candidates (default: the scan "
                        "family's own list)")
    p.add_argument("--index", action="store_true",
                   help="tune the persisted PQ/IVF-PQ ADC scan instead of "
                        "the dense scan")
    p.add_argument("--save", action="store_true",
                   help="persist the winner into the file's "
                        "PerformanceHints (footer rewrite; future opens "
                        "adopt it)")
    p.set_defaults(fn=cmd_tune)

    from .errors import MvtError

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (OSError, ValueError, MvtError) as exc:
        # bad paths / malformed files / wrong query shapes: one clean
        # line, not a traceback
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
