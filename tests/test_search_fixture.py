"""Spec-anchored search-chunk interop fixtures.

The 0x44/0x45 chunks here are assembled BYTE-BY-BYTE inside the test from
the SPEC_SEARCH.md wire layout and hash constants (sections 2.0, 2.1, 3.1,
3.2 — prime4bytes = 2654435761, entry bit = table[x>>3] & (1<<(x&7)),
reduction = OR-fold of upper half), deliberately NOT via
SearchTableConfig.marshal_* — a third, independent producer standing in
for reference-generated fixtures (no Go toolchain in this environment).
The searcher must consume them: planted patterns are always found (the
no-false-negative invariant) and a miss pattern skips the block without
decoding.

Reference: reference SPEC_SEARCH.md:30-92,200-280;
search_table.go:335-452; search_reader.go:451.
"""

import io

from minlz_jax import block as blockapi
from minlz_jax.minlz import MAGIC_CHUNK, crc, put_uvarint
from minlz_jax.search.searcher import BlockSearcher

PRIME4 = 2654435761


def _hash4(window: bytes, bits: int) -> int:
    """SPEC_SEARCH.md §3.1 HashValue for matchLen=4 (independent impl)."""
    val = int.from_bytes(window, "little")
    return ((val * PRIME4) & 0xFFFFFFFF) >> (32 - bits)


def _spec_table(data: bytes, bits: int, match_len: int = 4,
                prefixes: bytes = b"") -> bytearray:
    """Bit table per §2.1/§3.1: one bit per hashed window (type 1), or
    only windows following a prefix byte (type 2)."""
    table = bytearray(1 << max(bits - 3, 0))
    for i in range(len(data) - match_len + 1):
        if prefixes:
            if i == 0 or data[i - 1] not in prefixes:
                continue
        x = _hash4(data[i : i + match_len], bits)
        table[x >> 3] |= 1 << (x & 7)
    return table


def _chunk(ctype: int, payload: bytes) -> bytes:
    return bytes([ctype]) + len(payload).to_bytes(3, "little") + payload


def _data_chunk(data: bytes) -> bytes:
    comp = blockapi.encode(data)
    assert comp[:1] == b"\x00"
    return _chunk(0x02, crc(data).to_bytes(4, "little") + comp[1:])


def _stream(chunks, total: int) -> bytes:
    return (
        MAGIC_CHUNK + bytes([11])  # 2KiB max-block-size indicator
        + b"".join(chunks)
        + _chunk(0x20, put_uvarint(total))
    )


def _corpus() -> bytes:
    words = (b"alpha beta gamma delta epsilon zeta eta theta iota kappa "
             b"lambda mu nu xi omicron pi rho sigma tau upsilon ")
    return (words * 40)[:2048] + b" NEEDLE-IN-HAYSTACK " + (words * 20)[:700]


def test_hand_built_type1_chunks_consumed():
    data = _corpus()
    bits = 10
    # 0x44 info chunk: [type=1][matchLen=4][bits], §2.0.
    info = _chunk(0x44, bytes([1, 4, bits]))
    table = _spec_table(data, bits)
    # 0x45 table chunk: [type][mlen][bits][reductions][crc32][entries], §2.1.
    payload = bytes([1, 4, bits, 0]) + crc(bytes(table)).to_bytes(
        4, "little") + bytes(table)
    tbl = _chunk(0x45, payload)
    enc = _stream([info, tbl, _data_chunk(data)], len(data))

    # Planted pattern is found at its true offset.
    s = BlockSearcher(io.BytesIO(enc), b"NEEDLE-IN-HAYSTACK")
    got = [r.offset for r in s.search()]
    assert got == [data.index(b"NEEDLE-IN-HAYSTACK")]
    assert s.stats.tables_seen == 1
    assert s.stats.blocks_decoded == 1

    # No false negatives for every 6-byte window actually in the block.
    for start in range(0, len(data) - 6, 97):
        pat = data[start : start + 6]
        offs = [r.offset for r in
                BlockSearcher(io.BytesIO(enc), pat).search()]
        assert data.index(pat) in offs, (start, pat)

    # A pattern whose windows are absent skips the block without decode.
    s = BlockSearcher(io.BytesIO(enc), b"\x01\x02\x03\xfe\xfd\xfc")
    assert s.search() == []
    assert s.stats.blocks_skipped == 1
    assert s.stats.blocks_decoded == 0


def test_hand_built_type1_reduced_table():
    """§3.2: OR-fold the upper half once; header advertises reductions=1
    and the searcher masks indices to bits-1."""
    data = _corpus()
    bits = 10
    table = _spec_table(data, bits)
    half = len(table) // 2
    reduced = bytearray(
        bytes(a | b for a, b in zip(table[:half], table[half:]))
    )
    payload = bytes([1, 4, bits, 1]) + crc(bytes(reduced)).to_bytes(
        4, "little") + bytes(reduced)
    enc = _stream(
        [_chunk(0x44, bytes([1, 4, bits])), _chunk(0x45, payload),
         _data_chunk(data)],
        len(data),
    )
    got = [r.offset for r in
           BlockSearcher(io.BytesIO(enc), b"NEEDLE-IN-HAYSTACK").search()]
    assert got == [data.index(b"NEEDLE-IN-HAYSTACK")]
    s = BlockSearcher(io.BytesIO(enc), b"\x01\x02\x03\xfe\xfd\xfc")
    assert s.search() == []
    assert s.stats.blocks_skipped == 1


def test_hand_built_type2_byte_prefix_chunks():
    """Type 2 (byte prefix, §2.0/§2.1 prefix field = 8 bytes): only windows
    following a prefix byte are present; the searcher must still never
    false-negative and must skip on all-absent windows."""
    data = _corpus()
    bits = 10
    prefixes = b" aeiost-"  # 8 prefix values, space included
    table = _spec_table(data, bits, prefixes=prefixes)
    hdr = bytes([2, 4, bits]) + prefixes
    payload = hdr + bytes([0]) + crc(bytes(table)).to_bytes(
        4, "little") + bytes(table)
    enc = _stream(
        [_chunk(0x44, hdr), _chunk(0x45, payload), _data_chunk(data)],
        len(data),
    )
    s = BlockSearcher(io.BytesIO(enc), b"NEEDLE-IN-HAYSTACK")
    got = [r.offset for r in s.search()]
    assert got == [data.index(b"NEEDLE-IN-HAYSTACK")]
    # Sampled in-block patterns (length 7 so a prefixed window exists for
    # most): never a false negative regardless of usability.
    for start in range(0, len(data) - 7, 131):
        pat = data[start : start + 7]
        offs = [r.offset for r in
                BlockSearcher(io.BytesIO(enc), pat).search()]
        assert data.index(pat) in offs, (start, pat)
