"""Snappy fallback tests: block decode + legacy framed streams."""

import io

import pytest

from minlz_jax import block as blockapi
from minlz_jax import minlz
from minlz_jax.snappy import snappy_decode_block, snappy_encode_block
from minlz_jax.stream import Reader


def test_snappy_block_roundtrip(twain):
    enc = snappy_encode_block(twain)
    assert snappy_decode_block(enc) == twain


def test_golden_rawsnappy(twain):
    with open("testdata/Mark.Twain-Tom.Sawyer.txt.rawsnappy", "rb") as f:
        raw = f.read()
    assert snappy_decode_block(raw) == twain


def test_block_api_fallback(twain):
    """block.decode transparently decodes Snappy (non-zero first byte)."""
    enc = snappy_encode_block(twain)
    assert enc[0] != 0
    assert blockapi.decode(enc) == twain


def test_snappy_framed_stream(twain):
    # Build a Snappy framing-format stream by hand.
    enc = snappy_encode_block(twain)
    c = minlz.crc(twain)
    payload = c.to_bytes(4, "little") + enc
    stream = (
        b"\xff\x06\x00\x00sNaPpY"
        + bytes([0x00])
        + len(payload).to_bytes(3, "little")
        + payload
    )
    with pytest.raises(minlz.UnsupportedError):
        Reader(io.BytesIO(stream)).readall()
    got = Reader(io.BytesIO(stream), fallback=True).readall()
    assert got == twain


# --- S2 format extensions (reference decode.go:59-68, minlz.go:89) ----------


def test_s2_repeat_length_classes():
    """Hand-built S2 blocks exercising every repeat length class."""
    from minlz_jax.minlz import put_uvarint
    from minlz_jax.snappy import s2_decode_block

    def build(rep_bytes, want_len):
        # 8 literals 'abcdefgh', copy1(off=4,len=4) -> 'abcd', then a repeat
        # (offset stays 4) covering want_len bytes of the repeating pattern.
        lits = b"abcdefgh"
        total = len(lits) + 4 + want_len
        blk = bytearray(put_uvarint(total))
        blk.append((len(lits) - 1) << 2)  # literal tag
        blk += lits
        blk.append(1 | ((4 - 4) << 2))  # copy1 len=4
        blk.append(4)  # offset 4
        blk += rep_bytes
        return bytes(blk), lits + lits[4:8] + (lits[4:8] * (want_len // 4 + 2))[:want_len]

    # L=0..4 -> len 4..8
    for L in range(5):
        blk, want = build(bytes([1 | (L << 2), 0]), L + 4)
        assert s2_decode_block(blk) == want, L
    # L=5: 1 extra byte, len = 8 + b
    blk, want = build(bytes([1 | (5 << 2), 0, 100]), 108)
    assert s2_decode_block(blk) == want
    # L=6: 2 extra bytes, len = 260 + u16
    blk, want = build(bytes([1 | (6 << 2), 0]) + (1000).to_bytes(2, "little"), 1260)
    assert s2_decode_block(blk) == want
    # L=7: 3 extra bytes, len = 65540 + u24
    blk, want = build(bytes([1 | (7 << 2), 0]) + (12).to_bytes(3, "little"), 65552)
    assert s2_decode_block(blk) == want


def test_s2_repeat_before_copy_is_corrupt():
    from minlz_jax.minlz import put_uvarint
    from minlz_jax.snappy import s2_decode_block

    blk = bytearray(put_uvarint(8))
    blk.append(3 << 2)  # 4 literals
    blk += b"abcd"
    blk += bytes([1 | (0 << 2), 0])  # repeat len 4 with no prior copy
    with pytest.raises(minlz.CorruptError):
        s2_decode_block(bytes(blk))


def test_s2_encoder_roundtrip_with_repeats(twain):
    from minlz_jax.snappy import s2_decode_block, snappy_encode_block

    # Repeat-heavy data: record-structured text hits same-offset matches.
    data = (b"key=value,0123456789;" * 4000) + twain[:100_000]
    enc = snappy_encode_block(data, use_repeats=True)
    plain = snappy_encode_block(data, use_repeats=False)
    assert len(enc) < len(plain)  # repeats must actually engage
    assert s2_decode_block(enc) == data
    assert blockapi.decode(enc) == data  # block API fallback path


def test_s2_framed_stream(twain):
    from minlz_jax.snappy import snappy_encode_block

    enc = snappy_encode_block(twain, use_repeats=True)
    c = minlz.crc(twain)
    payload = c.to_bytes(4, "little") + enc
    stream = (
        b"\xff\x06\x00\x00S2sTwO"
        + bytes([0x00])
        + len(payload).to_bytes(3, "little")
        + payload
    )
    with pytest.raises(minlz.UnsupportedError):
        Reader(io.BytesIO(stream)).readall()
    assert Reader(io.BytesIO(stream), fallback=True).readall() == twain


def test_s2_oversized_block_rejected():
    from minlz_jax.minlz import put_uvarint

    # Declared decompressed size beyond s2.MaxBlockSize (4 MiB) -> ErrTooLarge
    # analog (reference decode.go:59-62).
    blk = put_uvarint((4 << 20) + 1) + b"\x00" * 16
    with pytest.raises(minlz.TooLargeError):
        blockapi.decode(blk)
