"""mz-compatible command line interface.

Parity surface with the reference CLI (cmd/mz/main.go:50-135 dispatch):
``c`` (compress), ``d`` (decompress), ``cat``, ``tail``, ``s`` (search),
``sidecar build|extract``, ``stats``, plus ``bench``.

Usage:
  python -m minlz_jax.cli c  [-1|-2|-3|-xfast] [-block] [-bs N] [-index]
                             [-pad N] [-recomp] [-device] [-o OUT] FILE...
  python -m minlz_jax.cli d  [-offset N] [-tail N] [-limit N] [-follow]
                             [-block-debug] [-o OUT] FILE...
  python -m minlz_jax.cli cat FILE...
  python -m minlz_jax.cli tail -n BYTES FILE
  python -m minlz_jax.cli s  [-q] [-l] [-c] [-n MAX] [-bail] [-stats]
                             [--sidecar SIDE] PATTERN FILE...
  python -m minlz_jax.cli sidecar build|extract [-o OUT] FILE
  python -m minlz_jax.cli stats [-blocks] FILE...
  python -m minlz_jax.cli bench [-n ITERS] FILE

File arguments support ``*`` and ``**`` globs (reference
cmd/internal/filepathx) and ``http(s)://`` URLs (reference
cmd/internal/shttp) where network access exists.
"""

from __future__ import annotations

import argparse
import glob as _glob
import io
import json
import os
import sys
import time

from . import block as blockapi
from . import minlz
from .stream import Index, Reader, ReadSeeker, Writer


def _out_path(path: str, suffix: str, explicit=None) -> str:
    if explicit:
        return explicit
    return path + suffix if suffix else path


def _expand(files):
    """Expand * and ** globs; pass URLs and plain paths through."""
    out = []
    for f in files:
        if f.startswith(("http://", "https://")) or os.path.exists(f):
            out.append(f)
        elif any(ch in f for ch in "*?["):
            hits = sorted(_glob.glob(f, recursive=True))
            out.extend(hits or [f])
        else:
            out.append(f)
    return out


def _read_input(path: str) -> bytes:
    if path.startswith(("http://", "https://")):
        from urllib.request import urlopen

        with urlopen(path) as r:  # noqa: S310 - explicit user-provided URL
            return r.read()
    with open(path, "rb") as f:
        return f.read()


def _open_input(path: str):
    """Seekable file-like over a path or URL.  URLs get the ranged HTTP
    reader (reference cmd/internal/shttp) so seek-driven commands
    (-offset/-tail) fetch only the ranges they touch; servers without
    Range support fall back to a whole-object download."""
    if path.startswith(("http://", "https://")):
        from .utils.shttp import HTTPReaderAt, RangeUnsupportedError

        try:
            return HTTPReaderAt(path)
        except RangeUnsupportedError:
            return io.BytesIO(_read_input(path))
    return open(path, "rb")


def cmd_compress(args) -> int:
    level = (
        minlz.LEVEL_SUPER_FAST
        if args.xfast
        else minlz.LEVEL_SMALLEST
        if args.l3
        else minlz.LEVEL_BALANCED
        if args.l2
        else minlz.LEVEL_FASTEST
    )
    if getattr(args, "bench", 0):
        return _compress_bench(args, level)
    for path in _expand(args.files):
        data = _read_input(path)
        if args.recomp:
            # Recompress existing MinLZ/Snappy input (reference -recomp).
            if data[:1] == b"\x00" and not data.startswith(minlz.MAGIC_CHUNK):
                data = blockapi.decode(data)
            elif data.startswith(minlz.MAGIC_CHUNK) or data.startswith(
                b"\xff\x06\x00\x00"
            ):
                data = Reader(io.BytesIO(data), fallback=True).readall()
        t0 = time.time()
        if args.block:
            if len(data) > minlz.MAX_BLOCK_SIZE:
                print(f"{path}: exceeds 8MiB block limit", file=sys.stderr)
                return 1
            out = blockapi.encode(data, level)
            opath = _out_path(path, ".mzb", args.output)
        else:
            search_cfg = None
            if args.search or args.search_len != 6:
                from .search import SearchTableConfig

                search_cfg = SearchTableConfig(match_len=args.search_len)
                search_cfg.compression = args.search_compress
            buf = io.BytesIO()
            with Writer(
                buf,
                level=level,
                block_size=args.bs,
                add_index=args.index,
                padding=args.pad,
                device=args.device,
                search_table=search_cfg,
                concurrency=getattr(args, "cpu", 0) or None,
            ) as w:
                w.encode_buffer(data)
            out = buf.getvalue()
            opath = _out_path(path, ".mz", args.output)
        dt = time.time() - t0
        with open(opath, "wb") as f:
            f.write(out)
        red = 100 - 100 * len(out) / max(len(data), 1)
        print(
            f"{path}: {len(data)} -> {len(out)} bytes ({red:.2f}% reduction,"
            f" {len(data) / max(dt, 1e-9) / 1e6:.0f} MB/s)"
        )
    return 0


def _compress_bench(args, level) -> int:
    """``mz c -bench=N [-verify]`` — repeat compression N times, report the
    best rate; with -verify every round-trip is checked (reference
    cmd/mz/compress.go:519-804)."""
    for path in _expand(args.files):
        data = _read_input(path)
        best = 1e18
        out = None
        for _ in range(args.bench):
            t0 = time.time()
            buf = io.BytesIO()
            with Writer(
                buf, level=level, block_size=args.bs, add_index=args.index,
                device=args.device,
                concurrency=getattr(args, "cpu", 0) or None,
            ) as w:
                w.encode_buffer(data)
            best = min(best, time.time() - t0)
            out = buf.getvalue()
            if args.verify:
                dec = Reader(io.BytesIO(out)).readall()
                if dec != data:
                    print(f"{path}: VERIFY FAILED", file=sys.stderr)
                    return 1
        red = 100 - 100 * len(out) / max(len(data), 1)
        tag = ", verified" if args.verify else ""
        print(
            f"{path}: {len(data)} -> {len(out)} bytes ({red:.2f}%), best of"
            f" {args.bench}: {len(data) / max(best, 1e-9) / 1e6:.1f} MB/s"
            f"{tag}"
        )
    return 0


def _parse_off_nl(value):
    """Parse an -offset/-tail value with optional '+nl' suffix: snap the
    start of the output forward to the next newline (reference
    cmd/mz/decompress.go '+nl')."""
    if value is None:
        return None, False
    s = str(value)
    nl = s.endswith("+nl")
    if nl:
        s = s[: -len("+nl")]
    return int(s or 0), nl


def _follow(path, args) -> int:
    """tail -f over a growing MinLZ stream (reference -follow,
    cmd/mz/decompress.go): re-open at the last decoded offset as the file
    grows; Ctrl-C exits."""
    offset = 0
    try:
        while True:
            with open(path, "rb") as f:
                r = Reader(f, ignore_missing_eof=True)
                try:
                    r.skip(offset)
                    data = r.read(-1)
                except EOFError:
                    data = b""
            if data:
                sys.stdout.buffer.write(data)
                sys.stdout.buffer.flush()
                offset += len(data)
            time.sleep(1.0)
    except KeyboardInterrupt:
        return 0


def cmd_block_debug(path: str, raw: bytes) -> int:
    """Dump per-op block anatomy (reference mz d -block-debug)."""
    from .oracle.decode import iter_ops

    if raw[:1] != b"\x00" or raw.startswith(minlz.MAGIC_CHUNK):
        # Stream: dump ops of every data chunk.
        pos = 0
        bno = 0
        while pos + 4 <= len(raw):
            ctype = raw[pos]
            clen = int.from_bytes(raw[pos + 1 : pos + 4], "little")
            if ctype in (0x02, 0x03):
                body = raw[pos + 8 : pos + 4 + clen]
                print(f"block {bno} @ {pos} ({clen - 4} comp bytes):")
                for rec in iter_ops(b"\x00" + body):
                    cpos, opos, kind, ln, off, lits = rec
                    extra = f" off={off}" if off else ""
                    extra += f" +{lits}lits" if lits else ""
                    print(f"  c{cpos:>7} o{opos:>8} {kind:<7} len={ln}{extra}")
                bno += 1
            pos += 4 + clen
    else:
        for rec in iter_ops(raw):
            cpos, opos, kind, ln, off, lits = rec
            extra = f" off={off}" if off else ""
            extra += f" +{lits}lits" if lits else ""
            print(f"c{cpos:>7} o{opos:>8} {kind:<7} len={ln}{extra}")
    return 0


def cmd_decompress(args, to_stdout=False) -> int:
    files = _expand(args.files)
    if getattr(args, "follow", False):
        return _follow(files[0], args)
    for path in files:
        if getattr(args, "block_debug", False):
            cmd_block_debug(path, _read_input(path))
            continue
        t0 = time.time()
        src = _open_input(path)
        head = src.read(16)
        src.seek(0)
        raw_len = None
        if path.endswith(".mzb") or (
            head[:1] == b"\x00" and not head.startswith(minlz.MAGIC_CHUNK)
        ):
            raw = src.read()
            raw_len = len(raw)
            data = blockapi.decode(raw)
        else:
            off, off_nl = _parse_off_nl(args.offset)
            tail, tail_nl = _parse_off_nl(args.tail)
            if off or args.tail is not None:
                # Seek path: the index walk + block fetches touch only the
                # ranges they need — on a ranged-HTTP source this never
                # downloads the whole object (reference shttp).
                rs = ReadSeeker(src)
                if args.tail is not None:
                    start = max(rs._index.total_uncompressed - tail, 0)
                else:
                    start = off
                rs.seek(start)
                data = rs.read(args.limit if args.limit else -1)
                if (off_nl or tail_nl) and start > 0:
                    # '+nl': snap the range start forward to the next line
                    # boundary (reference cmd/mz/decompress.go).
                    j = data.find(b"\n")
                    if j >= 0:
                        data = data[j + 1 :]
            elif getattr(args, "cpu", 0) > 1:
                from .utils.readahead import ReadaheadReader

                out = io.BytesIO()
                with ReadaheadReader(src) as ra:
                    Reader(ra).decode_concurrent(out, concurrency=args.cpu)
                data = out.getvalue()
                if args.limit:
                    data = data[: args.limit]
            else:
                from .utils.readahead import ReadaheadReader

                with ReadaheadReader(src) as ra:
                    data = Reader(
                        ra, device=getattr(args, "device", False)
                    ).readall()
                if args.limit:
                    data = data[: args.limit]
        if raw_len is None:
            raw_len = src.tell() if hasattr(src, "tell") else 0
        if hasattr(src, "close"):
            src.close()
        dt = time.time() - t0
        if to_stdout:
            sys.stdout.buffer.write(data)
            continue
        opath = args.output or (
            path[:-3] if path.endswith(".mz") else
            path[:-4] if path.endswith(".mzb") else path + ".out"
        )
        with open(opath, "wb") as f:
            f.write(data)
        print(
            f"{path}: {raw_len} -> {len(data)} bytes"
            f" ({len(data) / max(dt, 1e-9) / 1e6:.0f} MB/s)",
            file=sys.stderr,
        )
    return 0


def cmd_tail(args) -> int:
    path = args.files[0]
    src = _open_input(path)
    try:
        rs = ReadSeeker(src)
        start = max(rs._index.total_uncompressed - args.n, 0)
        rs.seek(start)
        sys.stdout.buffer.write(rs.read(-1))
    finally:
        src.close()
    return 0


def cmd_stats(args) -> int:
    for path in _expand(args.files):
        raw = _read_input(path)
        stats = {
            "file": path,
            "size": len(raw),
            "chunks": {},
            "blocks": 0,
            "uncompressed": 0,
        }
        if args.blocks:
            stats["ops"] = {}
            stats["op_bytes"] = {}
        search_pop = []
        pos = 0
        while pos + 4 <= len(raw):
            ctype = raw[pos]
            clen = int.from_bytes(raw[pos + 1 : pos + 4], "little")
            name = {
                0x00: "legacy",
                0x01: "uncompressed",
                0x02: "minlz",
                0x03: "minlz-ccrc",
                0x20: "eof",
                0x40: "index",
                0x44: "search-info",
                0x45: "search-table",
                0x46: "search-table-compressed",
                0x47: "remote-block-ref",
                0x88: "parse-hint",
                0xFE: "padding",
                0xFF: "stream-id",
            }.get(ctype, f"0x{ctype:02x}")
            ent = stats["chunks"].setdefault(name, {"count": 0, "bytes": 0})
            ent["count"] += 1
            ent["bytes"] += clen + 4
            if ctype in (0x45, 0x46):
                try:
                    import numpy as np

                    if ctype == 0x45:
                        from .search.table import parse_table_chunk as _p
                    else:
                        from .search.compressed import (
                            parse_compressed_table_chunk as _p,
                        )
                    _, _, _, tbl = _p(raw[pos + 4 : pos + 4 + clen])
                    pop = int(np.unpackbits(np.frombuffer(tbl, np.uint8)).sum())
                    search_pop.append(pop / (len(tbl) * 8))
                except minlz.CorruptError:
                    pass  # stats keep walking past corrupt table chunks
            if ctype == 0x46:
                # Disposition accounting (reference mz stats /
                # CompressedSearchStatsHook, search_compressed.go:110-177).
                try:
                    from .search.compressed import disposition_stats

                    d = disposition_stats(raw[pos + 4 : pos + 4 + clen])
                    agg = stats.setdefault("dispositions", {})
                    for k, v in d.items():
                        if not isinstance(v, dict):
                            agg[k] = agg.get(k, 0) + v
                            continue
                        a = agg.setdefault(
                            k, {"count": 0, "wire_bytes": 0}
                        )
                        a["count"] += v["count"]
                        a["wire_bytes"] += v["wire_bytes"]
                except minlz.CorruptError:
                    pass  # corrupt 0x46 payloads just skip the accounting
            if ctype in (0x01, 0x02, 0x03):
                stats["blocks"] += 1
                hist = stats.setdefault("block_size_hist", {})
                blog = max(clen - 4, 1).bit_length() - 1
                key = f"2^{blog}"
                hist[key] = hist.get(key, 0) + 1
                if getattr(args, "verify", False):
                    # Per-chunk CRC verification (reference mz stats
                    # -verify modes, cmd/mz/stats.go): decode every data
                    # chunk and check its checksum, reporting offsets of
                    # corrupt chunks instead of stopping at the first.
                    from .minlz import crc as _crc

                    v = stats.setdefault(
                        "verify", {"ok": 0, "bad": 0, "bad_offsets": []}
                    )
                    payload = raw[pos + 4 : pos + 4 + clen]
                    try:
                        want = int.from_bytes(payload[:4], "little")
                        body = payload[4:]
                        if ctype == 0x01:
                            good = _crc(body) == want
                        elif ctype == 0x03:
                            good = _crc(body) == want
                            blockapi.decode(b"\x00" + body)  # must parse
                        else:
                            good = _crc(
                                blockapi.decode(b"\x00" + body)
                            ) == want
                    except Exception:  # noqa: BLE001 - corrupt == bad
                        good = False
                    if good:
                        v["ok"] += 1
                    else:
                        v["bad"] += 1
                        if len(v["bad_offsets"]) < 16:
                            v["bad_offsets"].append(pos)
                if ctype == 0x01:
                    stats["uncompressed"] += clen - 4
                else:
                    try:
                        body = raw[pos + 8 : pos + 4 + clen]
                        v, _ = minlz.read_uvarint(body, 0)
                        stats["uncompressed"] += v
                        if args.blocks:
                            from .oracle.decode import iter_ops

                            for _, _, kind, ln, _, fl in iter_ops(
                                b"\x00" + body
                            ):
                                stats["ops"][kind] = (
                                    stats["ops"].get(kind, 0) + 1
                                )
                                stats["op_bytes"][kind] = (
                                    stats["op_bytes"].get(kind, 0) + ln + fl
                                )
                    except (ValueError, minlz.CorruptError):
                        pass
            pos += 4 + clen
        if stats["uncompressed"]:
            stats["ratio"] = round(len(raw) / stats["uncompressed"], 4)
        if search_pop:
            stats["search_tables"] = {
                "count": len(search_pop),
                "mean_population": round(sum(search_pop) / len(search_pop), 4),
            }
        if args.csv:
            flat = {
                "file": path,
                "size": stats["size"],
                "blocks": stats["blocks"],
                "uncompressed": stats["uncompressed"],
                "ratio": stats.get("ratio", ""),
            }
            if "verify" in stats:
                flat["crc_ok"] = stats["verify"]["ok"]
                flat["crc_bad"] = stats["verify"]["bad"]
            if path == _expand(args.files)[0]:
                print(",".join(flat))
            print(",".join(str(v) for v in flat.values()))
            # Per-chunk-type matrix rows (reference mz stats CSV matrices,
            # cmd/mz/stats.go): file,chunk,<type>,count,bytes.
            for name, ent in sorted(stats["chunks"].items()):
                print(
                    f"{path},chunk,{name},{ent['count']},{ent['bytes']}"
                )
        else:
            print(json.dumps(stats, indent=2))
        if stats.get("verify", {}).get("bad"):
            return 1
    return 0


def _match_line(path: str, offset: int) -> bytes:
    """Extract the line containing uncompressed ``offset`` via the seek
    index (reference mz search -l line extraction)."""
    with open(path, "rb") as f:
        rs = ReadSeeker(f)
        start = max(offset - 256, 0)
        rs.seek(start)
        window = rs.read(512 + 256)
    rel = offset - start
    lo = window.rfind(b"\n", 0, rel) + 1
    hi = window.find(b"\n", rel)
    if hi < 0:
        hi = len(window)
    return window[lo:hi]


def cmd_search(args) -> int:
    from .search import BlockSearcher
    from .search.sidecar import SidecarSearcher

    pattern = args.pattern.encode() if isinstance(args.pattern, str) else args.pattern
    rc = 1
    for path in _expand(args.files):
        n = [0]

        def cb(r, path=path):
            n[0] += 1
            if args.count_only:
                pass
            elif args.lines:
                try:
                    line = _match_line(path, r.offset)
                    print(f"{path}:{r.offset}: {line.decode(errors='replace')}")
                except Exception:
                    print(f"{path}:{r.offset}")
            elif not args.quiet:
                print(f"{path}:{r.offset}")
            if args.max and n[0] >= args.max:
                return False
            return True

        if args.sidecar:
            with open(args.sidecar, "rb") as sf, open(path, "rb") as mf:
                s = SidecarSearcher(sf, mf, pattern)
                s.search(cb)
        else:
            with open(path, "rb") as f:
                s = BlockSearcher(f, pattern, bail_no_table=args.bail)
                s.search(cb)
        if args.count_only:
            print(f"{path}: {n[0]}")
        if n[0]:
            rc = 0
        if args.stats:
            s.stats.fprint(sys.stderr)
    return rc


def cmd_sidecar(args) -> int:
    from .search import SearchTableConfig
    from .search.sidecar import build_sidecar, extract_sidecar

    path = _expand(args.files)[0]
    with open(path, "rb") as f:
        if args.action == "build":
            cfg = SearchTableConfig(match_len=args.search_len)
            side = build_sidecar(f, cfg)
        else:
            side = extract_sidecar(f)
    opath = args.output or path + ".mzs"
    with open(opath, "wb") as f:
        f.write(side)
    print(f"{opath}: {len(side)} bytes", file=sys.stderr)
    return 0


_VIS_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>minlz block visualizer</title><style>
body{font:13px monospace;background:#111;color:#ddd;margin:20px}
.bar{display:flex;flex-wrap:wrap;max-width:1200px}
.op{height:14px;margin:1px 0;opacity:.85}
.op:hover{opacity:1;outline:1px solid #fff}
.lit{background:#4a90d9}.copy1{background:#50b86c}.copy2{background:#e0a030}
.copy2f{background:#c86ad9}.copy3{background:#d95050}.repeat{background:#888}
#info{position:fixed;bottom:10px;left:20px;background:#000a;padding:6px}
.legend span{padding:2px 8px;margin-right:6px}
</style></head><body>
<h3>minlz block anatomy — FILE (N bytes decoded)</h3>
<div class="legend"><span class="lit">lit</span><span class="copy1">copy1</span>
<span class="copy2">copy2</span><span class="copy2f">fused</span>
<span class="copy3">copy3</span><span class="repeat">repeat</span></div>
<div class="bar" id="bar"></div><div id="info"></div>
<script>const ops = OPS;
const bar = document.getElementById('bar'), info = document.getElementById('info');
const total = ops.reduce((a,o)=>a+o[3]+(o[5]||0),0);
for (const o of ops){
  const d = document.createElement('div');
  d.className = 'op ' + o[2];
  d.style.width = Math.max(1, 1200*(o[3]+(o[5]||0))/total) + 'px';
  d.onmouseenter = () => info.textContent =
    `${o[2]} comp@${o[0]} out@${o[1]} len=${o[3]}` +
    (o[4]?` off=${o[4]}`:'') + (o[5]?` +${o[5]} fused lits`:'');
  bar.appendChild(d);
}
</script></body></html>
"""


def cmd_vis(args) -> int:
    """Render a block's op layout as standalone HTML (parity: the
    reference's block-vis/ tool)."""
    from .oracle.decode import iter_ops

    path = _expand(args.files)[0]
    raw = _read_input(path)
    if raw[:1] != b"\x00" or raw.startswith(minlz.MAGIC_CHUNK):
        # Take the first data chunk of a stream.
        pos = 0
        blk = None
        while pos + 4 <= len(raw):
            ctype = raw[pos]
            clen = int.from_bytes(raw[pos + 1 : pos + 4], "little")
            if ctype in (0x02, 0x03):
                blk = b"\x00" + raw[pos + 8 : pos + 4 + clen]
                break
            pos += 4 + clen
        if blk is None:
            print("no compressed block found", file=sys.stderr)
            return 1
        raw = blk
    ops = [list(rec) for rec in iter_ops(raw)]
    n = sum(o[3] + o[5] for o in ops)
    html = (
        _VIS_HTML.replace("OPS", json.dumps(ops))
        .replace("FILE", os.path.basename(path))
        .replace("N", str(n))
    )
    opath = args.output or path + ".html"
    with open(opath, "w") as f:
        f.write(html)
    print(f"{opath}: {len(ops)} ops", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    path = args.files[0]
    with open(path, "rb") as f:
        data = f.read()
    best_enc = best_dec = 1e9
    out = None
    for _ in range(args.n):
        t0 = time.time()
        buf = io.BytesIO()
        with Writer(buf, add_index=False, device=args.device) as w:
            w.encode_buffer(data)
        best_enc = min(best_enc, time.time() - t0)
        out = buf.getvalue()
        t0 = time.time()
        dec = Reader(io.BytesIO(out), device=args.device).readall()
        best_dec = min(best_dec, time.time() - t0)
        if dec != data:
            print("VERIFY FAILED", file=sys.stderr)
            return 1
    print(
        f"{path}: {len(data)}B -> {len(out)}B"
        f" ({100 - 100 * len(out) / len(data):.2f}%)"
        f" enc {len(data) / best_enc / 1e6:.1f} MB/s"
        f" dec {len(data) / best_dec / 1e6:.1f} MB/s (verified)"
    )
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mz", description=__doc__)
    # Profiling flags (reference -cpuprof/-memprof/-traceprof,
    # cmd/mz/main.go:51-107; trace is the jax.profiler analog).
    p.add_argument("--cpuprof", metavar="FILE",
                   help="write a cProfile dump of the run to FILE")
    p.add_argument("--memprof", metavar="FILE",
                   help="write a tracemalloc top-stats dump to FILE")
    p.add_argument("--traceprof", metavar="DIR",
                   help="capture a jax.profiler trace into DIR")
    sub = p.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("c", help="compress")
    pc.add_argument("-xfast", action="store_true", help="level -1 SuperFast")
    pc.add_argument("-1", dest="l1", action="store_true", help="level 1")
    pc.add_argument("-2", dest="l2", action="store_true", help="level 2")
    pc.add_argument("-3", dest="l3", action="store_true", help="level 3")
    pc.add_argument("-block", action="store_true", help="single block (.mzb)")
    pc.add_argument("-bs", type=int, default=minlz.DEFAULT_BLOCK_SIZE)
    pc.add_argument("-index", action="store_true", default=True)
    pc.add_argument("-no-index", dest="index", action="store_false")
    pc.add_argument("-pad", type=int, default=0)
    pc.add_argument("-recomp", action="store_true",
                    help="recompress MinLZ/Snappy input")
    pc.add_argument("-search", action="store_true",
                    help="embed per-block search tables")
    pc.add_argument("-search.len", dest="search_len", type=int, default=6,
                    help="search table match length (1-8)")
    pc.add_argument("-search.compress", dest="search_compress",
                    action="store_true", default=True)
    pc.add_argument("-search.no-compress", dest="search_compress",
                    action="store_false")
    pc.add_argument("-device", action="store_true",
                    help="device encode path")
    pc.add_argument("-cpu", type=int, default=0,
                    help="encode concurrency (0 = auto)")
    pc.add_argument("-bench", type=int, default=0, metavar="N",
                    help="benchmark: compress N times, report best rate")
    pc.add_argument("-verify", action="store_true",
                    help="with -bench: round-trip check every iteration")
    pc.add_argument("-o", dest="output")
    pc.add_argument("files", nargs="+")
    pc.set_defaults(fn=cmd_compress)

    for name, stdout in (("d", False), ("cat", True)):
        pd = sub.add_parser(name, help="decompress" + (" to stdout" if stdout else ""))
        pd.add_argument("-offset", default=0,
                        help="start offset; '+nl' suffix snaps to newline")
        pd.add_argument("-tail", default=None,
                        help="last N bytes; '+nl' suffix snaps to newline")
        pd.add_argument("-limit", type=int, default=0)
        pd.add_argument("-follow", action="store_true",
                        help="keep reading as the file grows (tail -f)")
        pd.add_argument("-block-debug", dest="block_debug",
                        action="store_true", help="dump per-op anatomy")
        pd.add_argument("-cpu", type=int, default=0,
                        help="concurrent block decode threads")
        pd.add_argument("-device", action="store_true")
        pd.add_argument("-o", dest="output")
        pd.add_argument("files", nargs="+")
        pd.set_defaults(fn=lambda a, s=stdout: cmd_decompress(a, s))

    pt = sub.add_parser("tail", help="output last N uncompressed bytes")
    pt.add_argument("-n", type=int, required=True)
    pt.add_argument("files", nargs=1)
    pt.set_defaults(fn=cmd_tail)

    ps = sub.add_parser("stats", help="stream anatomy")
    ps.add_argument("-blocks", action="store_true",
                    help="per-op histograms (decodes block headers)")
    ps.add_argument("-csv", action="store_true")
    ps.add_argument("-verify", action="store_true",
                    help="decode + CRC-check every data chunk; exit 1 "
                         "and report offsets when any chunk is corrupt")
    ps.add_argument("files", nargs="+")
    ps.set_defaults(fn=cmd_stats)

    pq = sub.add_parser("s", help="search compressed stream",
                        aliases=["search", "find"])
    pq.add_argument("-q", dest="quiet", action="store_true")
    pq.add_argument("-l", dest="lines", action="store_true",
                    help="print the matching line")
    pq.add_argument("-c", dest="count_only", action="store_true",
                    help="print only the match count per file")
    pq.add_argument("-n", dest="max", type=int, default=0,
                    help="stop after N matches")
    pq.add_argument("-bail", action="store_true",
                    help="error if stream has no search tables")
    pq.add_argument("-stats", action="store_true")
    pq.add_argument("--sidecar", default=None,
                    help="search via a sidecar index file")
    pq.add_argument("pattern")
    pq.add_argument("files", nargs="+")
    pq.set_defaults(fn=cmd_search)

    pside = sub.add_parser("sidecar", help="build/extract search sidecars")
    pside.add_argument("action", choices=["build", "extract"])
    pside.add_argument("-search.len", dest="search_len", type=int, default=6)
    pside.add_argument("-o", dest="output")
    pside.add_argument("files", nargs=1)
    pside.set_defaults(fn=cmd_sidecar)

    pv = sub.add_parser("vis", help="render block anatomy to HTML")
    pv.add_argument("-o", dest="output")
    pv.add_argument("files", nargs=1)
    pv.set_defaults(fn=cmd_vis)

    pb = sub.add_parser("bench", help="compress/decompress benchmark")
    pb.add_argument("-n", type=int, default=3)
    pb.add_argument("-device", action="store_true")
    pb.add_argument("files", nargs=1)
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if getattr(args, "device", False):
        from .utils.compile_cache import configure_compile_cache

        configure_compile_cache()

    def run():
        try:
            return args.fn(args)
        except BrokenPipeError:
            return 0

    if args.memprof:
        import tracemalloc

        tracemalloc.start()
    if args.traceprof:
        import jax

        with jax.profiler.trace(args.traceprof):
            rc = _run_cpuprof(run, args.cpuprof)
    else:
        rc = _run_cpuprof(run, args.cpuprof)
    if args.memprof:
        import tracemalloc

        snap = tracemalloc.take_snapshot()
        with open(args.memprof, "w") as f:
            for st in snap.statistics("lineno")[:100]:
                f.write(f"{st}\n")
        tracemalloc.stop()
    return rc


def _run_cpuprof(run, path):
    if not path:
        return run()
    import cProfile

    prof = cProfile.Profile()
    prof.enable()
    try:
        return run()
    finally:
        prof.disable()
        prof.dump_stats(path)


if __name__ == "__main__":
    sys.exit(main())
