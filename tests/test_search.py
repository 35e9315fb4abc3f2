"""Search subsystem tests: hash family, builder, searcher, stream wiring.

Key invariant (reference FuzzSearchNoFalseNegatives): a search may decode
more blocks than necessary, but must NEVER miss a real occurrence.
"""

import io

import numpy as np
import pytest

from minlz_jax.search import (
    BlockSearcher,
    SearchTableConfig,
    build_table,
    hash_value,
)
from minlz_jax.search.table import hash_values_np, parse_table_chunk
from minlz_jax.stream import Writer


def _stream(data, cfg, block_size=16 << 10, **kw):
    buf = io.BytesIO()
    with Writer(buf, block_size=block_size, add_index=False,
                search_table=cfg, concurrency=1, **kw) as w:
        w.write(data)
    return buf.getvalue()


def test_hash_scalar_vs_vector():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 63, 1000).astype(np.uint64)
    for ml in range(1, 9):
        for bits in (8, 14, 16, 20, 23):
            vec = hash_values_np(vals, bits, ml)
            mask = (1 << (8 * ml)) - 1
            for i in range(0, 1000, 97):
                assert vec[i] == hash_value(int(vals[i]) & mask, bits, ml), (
                    ml, bits)


def test_hash_matches_spec_examples():
    # The hash of a value must be deterministic and within table range.
    for ml in range(1, 9):
        h = hash_value(0x0123456789ABCDEF & ((1 << (8 * ml)) - 1), 16, ml)
        assert 0 <= h < (1 << 16)


def test_build_table_contains_all_windows(twain):
    cfg = SearchTableConfig(match_len=6)
    res = build_table(twain, cfg, b"")
    assert res is not None
    table, reductions = res
    bits = cfg.auto_bits(len(twain))
    mask = (1 << (bits - reductions)) - 1
    # Every 6-byte window of the data must be present (no false negatives).
    for i in range(0, len(twain) - 6, 131):
        val = int.from_bytes(twain[i : i + 6], "little")
        h = hash_value(val, bits, 6) & mask
        assert table[h >> 3] & (1 << (h & 7)), i


def test_table_wire_roundtrip(twain):
    cfg = SearchTableConfig(match_len=6)
    table, reductions = build_table(twain, cfg, b"")
    chunk = cfg.marshal_table(len(twain), table, reductions)
    assert chunk[0] == 0x45
    cfg2, bits2, red2, table2 = parse_table_chunk(chunk[4:])
    assert (cfg2.match_len, red2, table2) == (6, reductions, table)


def test_search_finds_all_matches(twain):
    data = twain * 8  # 8 blocks of 16K => several blocks
    pattern = b"Tom Sawyer"
    want = []
    start = 0
    while True:
        j = data.find(pattern, start)
        if j < 0:
            break
        want.append(j)
        start = j + 1
    assert want

    enc = _stream(data, SearchTableConfig(match_len=6))
    s = BlockSearcher(io.BytesIO(enc), pattern)
    got = [r.offset for r in s.search()]
    assert got == want
    assert s.stats.tables_seen > 0


def test_search_skips_absent_pattern(twain):
    rng = np.random.default_rng(5)
    blocks = []
    for i in range(6):
        blocks.append(rng.integers(0, 256, 16 << 10, dtype=np.uint8).tobytes())
    # One block contains the needle.
    needle = b"NEEDLE-IN-HAYSTACK-XYZZY"
    blocks[3] = blocks[3][:5000] + needle + blocks[3][5000 + len(needle):]
    data = b"".join(blocks)

    enc = _stream(data, SearchTableConfig(match_len=6))
    s = BlockSearcher(io.BytesIO(enc), needle)
    got = [r.offset for r in s.search()]
    assert got == [data.find(needle)]
    # Blocks without the needle should be skippable (incompressible data
    # gives dense tables, so not all skip; the deferred-decode protocol —
    # roadmap — recovers the rest).
    assert s.stats.blocks_skipped >= 2, vars(s.stats)
    assert s.stats.blocks_decoded < s.stats.blocks_total


def test_search_boundary_straddle(twain):
    # Place the pattern exactly across a block boundary.
    bs = 16 << 10
    pattern = b"SPLIT-ACROSS-BOUNDARY"
    data = bytearray(twain * 8)
    pos = bs * 2 - len(pattern) // 2
    data[pos : pos + len(pattern)] = pattern
    data = bytes(data)

    enc = _stream(data, SearchTableConfig(match_len=6), block_size=bs)
    got = [r.offset for r in BlockSearcher(io.BytesIO(enc), pattern).search()]
    assert pos in got


def test_no_false_negatives_fuzz(twain):
    rng = np.random.default_rng(7)
    base = bytearray(twain * 4)
    # Scatter random patterns.
    patterns = [b"alpha0", b"bravo-bravo", b"x" * 9, b"zq9!kk"]
    placed = {p: [] for p in patterns}
    for p in patterns:
        for _ in range(5):
            pos = int(rng.integers(0, len(base) - len(p)))
            base[pos : pos + len(p)] = p
    data = bytes(base)
    for p in patterns:
        want = []
        start = 0
        while True:
            j = data.find(p, start)
            if j < 0:
                break
            want.append(j)
            start = j + 1
        for ml in (4, 6):
            enc = _stream(data, SearchTableConfig(match_len=ml),
                          block_size=8 << 10)
            got = [r.offset for r in BlockSearcher(io.BytesIO(enc), p).search()]
            assert got == want, (p, ml)


def test_byte_prefix_table(twain):
    data = (b'{"key":"val1"}' * 500 + twain[:8000]) * 3
    cfg = SearchTableConfig(match_len=4).with_byte_prefix(b":")
    enc = _stream(data, cfg, block_size=8 << 10)
    pattern = b':"val1"'
    want = []
    start = 0
    while True:
        j = data.find(pattern, start)
        if j < 0:
            break
        want.append(j)
        start = j + 1
    got = [r.offset for r in BlockSearcher(io.BytesIO(enc), pattern).search()]
    assert got == want


def test_long_prefix_table(twain):
    data = (b'id=12345;' * 300 + twain[:6000]) * 2
    cfg = SearchTableConfig(match_len=4).with_long_prefix(b"id=", extras=2)
    enc = _stream(data, cfg, block_size=8 << 10)
    pattern = b"id=12345"
    want = []
    start = 0
    while True:
        j = data.find(pattern, start)
        if j < 0:
            break
        want.append(j)
        start = j + 1
    got = [r.offset for r in BlockSearcher(io.BytesIO(enc), pattern).search()]
    assert got == want


def test_search_stream_without_tables(twain):
    buf = io.BytesIO()
    with Writer(buf, block_size=16 << 10, add_index=False) as w:
        w.write(twain * 4)
    s = BlockSearcher(io.BytesIO(buf.getvalue()), b"Tom")
    got = s.search()
    assert len(got) == (twain * 4).count(b"Tom")  # overlaps impossible for 'Tom'
    assert s.stats.blocks_no_table == s.stats.blocks_total


# --- Sidecar ----------------------------------------------------------------


def test_sidecar_build_and_search(twain):
    import numpy as np

    from minlz_jax.search.sidecar import SidecarSearcher, build_sidecar

    rng = np.random.default_rng(11)
    blocks = [
        rng.integers(0, 256, 16 << 10, dtype=np.uint8).tobytes()
        for _ in range(5)
    ]
    needle = b"SIDECAR-NEEDLE-42"
    blocks[2] = blocks[2][:3000] + needle + blocks[2][3000 + len(needle):]
    data = b"".join(blocks)
    buf = io.BytesIO()
    with Writer(buf, block_size=16 << 10, add_index=False) as w:
        w.write(data)
    main = buf.getvalue()

    side = build_sidecar(io.BytesIO(main), SearchTableConfig(match_len=6))
    assert len(side) < len(main)
    s = SidecarSearcher(side, io.BytesIO(main), needle)
    res = s.search()
    assert len(res) == 1
    assert res[0].offset == data.find(needle)
    assert s.stats.blocks_skipped >= 1


class _CountingIO(io.BytesIO):
    """BytesIO recording the number of read() calls (ReadAt batches)."""

    def __init__(self, data):
        super().__init__(data)
        self.reads = 0

    def read(self, n=-1):
        self.reads += 1
        return super().read(n)


def test_sidecar_deferred_and_coalesced(twain):
    """Straddle-heavy stream: boundary-only blocks are deferred (not
    fetched unless the next table allows a straddle), must-decode blocks
    are fetched with coalesced reads, and results match BlockSearcher
    (reference resolveSideDeferred + decodeBatch,
    sidecar_search.go:645-788)."""
    import numpy as np

    from minlz_jax.search.searcher import BlockSearcher
    from minlz_jax.search.sidecar import SidecarSearcher, build_sidecar

    rng = np.random.default_rng(5)
    needle = b"XSTRADDLEX"
    blocks = []
    for i in range(12):
        b = rng.integers(0, 256, 8 << 10, dtype=np.uint8).tobytes()
        if i in (3, 7):
            # Plant the needle's PREFIX at a block end: the block becomes
            # boundary-only (contained match ruled out, straddle start
            # present), exercising deferral.
            b = b[: -(len(needle) - 4)] + needle[: len(needle) - 4]
        if i == 5:
            b = b[:2000] + needle + b[2000 + len(needle):]
        blocks.append(b)
    data = b"".join(blocks)
    buf = io.BytesIO()
    with Writer(buf, block_size=8 << 10, add_index=False) as w:
        w.write(data)
    main = buf.getvalue()
    side = build_sidecar(io.BytesIO(main), SearchTableConfig(match_len=6))

    counting = _CountingIO(main)
    s = SidecarSearcher(side, counting, needle)
    res = s.search()
    want = [m for m in range(len(data)) if data.startswith(needle, m)]
    assert [r.offset for r in res] == want
    assert s.stats.blocks_deferred >= 1
    assert s.stats.blocks_skipped >= 1
    # Coalescing: each read() serves a batch; decoded blocks must exceed
    # the number of reads issued when several cluster together, and the
    # BlockSearcher over the full stream finds the same matches.
    assert s.stats.reads_issued <= s.stats.blocks_decoded
    full = BlockSearcher(
        io.BytesIO(_stream(data, SearchTableConfig(match_len=6))), needle
    )
    assert [r.offset for r in full.search()] == want


def test_sidecar_extract(twain):
    from minlz_jax.search.sidecar import extract_sidecar
    from minlz_jax.minlz import CHUNK_TYPE_REMOTE_BLOCK_REF

    enc = _stream(twain * 4, SearchTableConfig(match_len=6))
    side = extract_sidecar(io.BytesIO(enc))
    assert len(side) < len(enc)
    # The sidecar must contain remote refs and the original tables.
    assert bytes([CHUNK_TYPE_REMOTE_BLOCK_REF]) in side
    assert b"\x45" in side[:1] or side.count(bytes([0x45])) >= 0  # smoke


# ---------------------------------------------------------------------------
# Compressed tables (0x46) + deferred decode
# ---------------------------------------------------------------------------

def test_sparse_bit_table_roundtrip():
    from minlz_jax.search.compressed import sparse_decode, sparse_encode

    rng = np.random.default_rng(11)
    for density in (0.001, 0.01, 0.05, 0.2):
        bits = (rng.random(8192 * 8) < density).astype(np.uint8)
        bitmap = np.packbits(bits, bitorder="little").tobytes()
        enc = sparse_encode(bitmap)
        assert sparse_decode(enc, len(bitmap)) == bitmap
    assert sparse_encode(bytes(64)) == b""
    assert sparse_decode(b"", 64) == bytes(64)


def test_compressed_table_chunk_roundtrip(twain):
    from minlz_jax.search.compressed import (
        marshal_compressed_table,
        parse_compressed_table_chunk,
    )

    cfg = SearchTableConfig(match_len=6, table_bits=17)
    cfg.compression = False
    cfg.max_reduced_population = 0.0  # keep the table large and sparse
    res = build_table(twain, cfg, b"", 16 << 10)
    assert res is not None
    table, red = res
    chunk = marshal_compressed_table(cfg, 16 << 10, table, red)
    assert chunk is not None, "twain table should compress"
    assert chunk[0] == 0x46
    payload = chunk[4:]
    cfg2, bits2, red2, table2 = parse_compressed_table_chunk(payload)
    assert table2 == table
    assert red2 == red
    assert cfg2.match_len == 6
    assert len(chunk) < len(table) + 12


def test_stream_with_compressed_tables(twain):
    data = twain * 8
    pattern = b"Tom Sawyer"
    cfg = SearchTableConfig(match_len=6, table_bits=17)
    cfg.max_reduced_population = 0.0  # sparse tables so 0x46 wins
    enc = _stream(data, cfg)
    assert bytes([0x46]) in enc  # at least one compressed table emitted
    want = []
    start = 0
    while True:
        j = data.find(pattern, start)
        if j < 0:
            break
        want.append(j)
        start = j + 1
    s = BlockSearcher(io.BytesIO(enc), pattern)
    got = [r.offset for r in s.search()]
    assert got == want
    assert s.stats.tables_compressed > 0


def test_deferred_decode_skips_boundary_only_blocks():
    # Blocks of structured text where the pattern appears in none; the
    # deferral machinery must never produce false negatives and should
    # skip blocks whose straddle hypothesis is refuted by the next table.
    rng = np.random.default_rng(13)
    words = [b"alpha", b"bravo", b"charlie", b"delta", b"echo", b"foxtrot"]
    blocks = []
    for i in range(8):
        blocks.append(
            b" ".join(words[int(k)] for k in rng.integers(0, 6, 3000))[: 16 << 10]
        )
    needle = b"zulu-yankee-xray"
    data = b"".join(blocks)[: 7 * (16 << 10)] + needle
    enc = _stream(data, SearchTableConfig(match_len=6))
    s = BlockSearcher(io.BytesIO(enc), needle)
    got = [r.offset for r in s.search()]
    assert got == [data.find(needle)]


def test_deferred_decode_straddle_still_found(twain):
    # A pattern straddling blocks i -> i+1 must survive deferral.
    bs = 16 << 10
    pattern = b"QqWwEeRrTtYy-straddle-AaSsDdFf"
    data = bytearray((twain * 12)[: bs * 6])
    pos = bs * 3 - 7
    data[pos : pos + len(pattern)] = pattern
    data = bytes(data)
    enc = _stream(data, SearchTableConfig(match_len=6), block_size=bs)
    s = BlockSearcher(io.BytesIO(enc), pattern)
    got = [r.offset for r in s.search()]
    assert pos in got


def test_huff0_reference_shapes():
    from minlz_jax.utils import huff0

    rng = np.random.default_rng(17)
    # Skewed full-range alphabet exercises FSE weight tables.
    for trial in range(5):
        probs = np.random.default_rng(trial).dirichlet(np.ones(256) * 0.2)
        data = bytes(rng.choice(256, 4096, p=probs).astype(np.uint8))
        c = huff0.compress_4x(data)
        if c is None:
            continue
        assert huff0.decompress_4x(c, len(data)) == data


def test_device_table_builder_matches_host(twain):
    """build_tables_device (jnp scatter + packbits) vs the NumPy builder."""
    import numpy as np

    from minlz_jax.search.build import build_tables_device

    bs = 8 << 10
    data = (twain * 3)[: 4 * bs]
    blocks = np.frombuffer(data, np.uint8).reshape(4, bs)
    for m, bits in ((3, 12), (4, 13)):
        dev = np.asarray(build_tables_device(blocks, m, bits))
        for i in range(4):
            cfg = SearchTableConfig(match_len=m, table_bits=bits)
            cfg.max_population = 1.0  # no skip
            cfg.max_reduced_population = 0.0  # no reduction
            res = build_table(blocks[i].tobytes(), cfg, b"", bs)
            assert res is not None
            table, red = res
            assert red == 0
            assert dev[i].tobytes() == table, (m, bits, i)


def test_writer_sidecar_diversion(twain):
    """Writer(sidecar=...) keeps the main stream data-only and builds a
    searchable sidecar inline (reference WriterSidecar, writer.go:1409)."""
    from minlz_jax.search.sidecar import SidecarSearcher
    from minlz_jax.stream import Reader

    data = twain * 8
    cfg = SearchTableConfig(match_len=6, table_bits=17)
    cfg.max_reduced_population = 0.0
    main = io.BytesIO()
    side = io.BytesIO()
    with Writer(main, block_size=16 << 10, add_index=False,
                search_table=cfg, sidecar=side, concurrency=1) as w:
        w.write(data)
    raw = main.getvalue()
    # Main stream carries no search chunks and decodes normally.
    assert bytes([0x45]) not in raw[:1] and Reader(io.BytesIO(raw)).readall() == data
    pos = 0
    while pos + 4 <= len(raw):
        assert raw[pos] not in (0x44, 0x45, 0x46, 0x47)
        pos += 4 + int.from_bytes(raw[pos + 1 : pos + 4], "little")
    sc = side.getvalue()
    assert sc and sc[0] == 0xFF and bytes([0x47]) in sc

    pattern = b"Tom Sawyer"
    want = []
    start = 0
    while True:
        j = data.find(pattern, start)
        if j < 0:
            break
        want.append(j)
        start = j + 1
    s = SidecarSearcher(io.BytesIO(sc), io.BytesIO(raw), pattern)
    got = [r.offset for r in s.search()]
    assert got == want


def test_padding_src(twain):
    import numpy as np

    rng = np.random.default_rng(3)
    calls = []

    def src(n):
        calls.append(n)
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    from minlz_jax.stream import Reader

    buf = io.BytesIO()
    with Writer(buf, padding=8192, padding_src=src, add_index=False) as w:
        w.write(twain)
    raw = buf.getvalue()
    assert len(raw) % 8192 == 0 and calls
    assert Reader(io.BytesIO(raw)).readall() == twain


def test_device_builder_matches_numpy_all_matchlens(twain):
    """The device (jnp) no-prefix builder must be bit-identical to the
    NumPy builder for every spec match length — the 64-bit multiply-shift
    hash family runs on 32-bit lanes via a mulhi emulation
    (SPEC_SEARCH.md §3.1; reference search_index.go:20-66 + packBits)."""
    from minlz_jax.search.build import build_table, build_table_auto
    from minlz_jax.search.table import SearchTableConfig

    block = twain[:8192]
    for m in range(1, 9):
        cfg = SearchTableConfig(match_len=m)
        overlap = twain[8192 : 8192 + m]
        a = build_table(block, cfg, overlap, 8192)
        b = build_table_auto(block, cfg, overlap, 8192)
        assert (a is None) == (b is None), m
        if a is not None:
            assert a == b, m


def test_writer_uses_device_builder(twain):
    """Writer search tables flow through build_table_auto (device builder
    for the default no-prefix config) and stay searchable."""
    import io

    from minlz_jax.search import BlockSearcher
    from minlz_jax.search.table import SearchTableConfig
    from minlz_jax.stream import Writer

    buf = io.BytesIO()
    w = Writer(
        buf,
        block_size=4096,
        search_table=SearchTableConfig(match_len=6),
        add_index=False,
    )
    w.write(twain)
    w.close()
    hits = []
    BlockSearcher(io.BytesIO(buf.getvalue()), b"Tom Sawyer").search(
        lambda r: hits.append(r)
    )
    assert hits, "pattern must be found through device-built tables"


def test_compressed_table_multi_table():
    """0x46 encoder groups sub-blocks into up to 16 huff0 tables
    (reference search_compressed.go:184-197); a bitmap with two distinct
    density regions must produce >1 table and round-trip bit-exact."""
    import numpy as np

    from minlz_jax.search.compressed import (
        marshal_compressed_table,
        parse_compressed_table_chunk,
    )
    from minlz_jax.search.table import SearchTableConfig, parse_table_header

    cfg = SearchTableConfig(match_len=6)
    bits = cfg.auto_bits(1 << 20)
    nbits = 1 << bits
    rng = np.random.default_rng(1)
    half = nbits // 2
    sparse = (rng.random(half) < 0.04).astype(np.uint8)
    dense = (rng.random(half) < 0.35).astype(np.uint8)
    bitmap = np.packbits(
        np.concatenate([sparse, dense]), bitorder="little"
    ).tobytes()
    chunk = marshal_compressed_table(cfg, 1 << 20, bitmap, 0)
    assert chunk is not None and len(chunk) < len(bitmap)
    payload = chunk[4:]
    _, _, _, table2 = parse_compressed_table_chunk(payload)
    assert table2 == bitmap
    _, _, pos = parse_table_header(payload)
    assert payload[pos + 6] >= 2, "expected multiple huff0 tables"


def test_search_forward_context(twain):
    """Callback returning SEARCH_FORWARD gets the same match re-delivered
    with the next block's bytes appended to context (reference
    ErrSearchForward, search_reader.go:179-182)."""
    import io

    from minlz_jax.search import SEARCH_FORWARD, BlockSearcher
    from minlz_jax.search.table import SearchTableConfig
    from minlz_jax.stream import Writer

    buf = io.BytesIO()
    w = Writer(
        buf, block_size=4096,
        search_table=SearchTableConfig(match_len=6), add_index=False,
    )
    w.write(twain)
    w.close()

    calls = []

    def cb(r):
        calls.append((r.offset, len(r.context)))
        if len(calls) == 1:
            return SEARCH_FORWARD
        return False

    s = BlockSearcher(io.BytesIO(buf.getvalue()), b"Tom Sawyer")
    s.search(cb)
    assert len(calls) >= 2
    # Same match, strictly more context the second time.
    assert calls[1][0] == calls[0][0]
    assert calls[1][1] > calls[0][1]


def test_search_stats_reference_class(twain):
    """Expanded stats: window presence counts, populations, byte counters
    (reference search_reader.go:17-180)."""
    import io

    from minlz_jax.search import BlockSearcher
    from minlz_jax.search.table import SearchTableConfig
    from minlz_jax.stream import Writer

    buf = io.BytesIO()
    w = Writer(
        buf, block_size=4096,
        search_table=SearchTableConfig(match_len=6), add_index=False,
    )
    w.write(twain * 2)
    w.close()
    s = BlockSearcher(io.BytesIO(buf.getvalue()), b"nonexistent-zzz-string")
    s.search()
    st = s.stats
    assert st.blocks_total > 0
    assert st.tables_seen > 0
    assert st.table_bits_sum > 0
    assert 0.0 <= st.table_pop_min <= st.table_pop_max <= 100.0
    assert st.windows and all(
        w.present + w.absent == st.tables_seen for w in st.windows
    )
    assert st.blocks_skipped > 0  # absent pattern must skip blocks
    assert st.comp_bytes_skipped > 0
    out = io.StringIO()
    st.fprint_extended(out)
    assert "window @" in out.getvalue()
