"""External interop proof for the clean-room huff0 codec (utils/huff0.py).

The 0x46 compressed-search-table chunk stores Huffman tables in the
zstd/klauspost-huff0 wire format: RFC 8878 §4.2.1 tree descriptions
(FSE-compressed or direct weights) followed by 4-stream bodies with a
6-byte jump table.  The reference consumes/produces these with klauspost's
huff0 (reference search_compressed.go:785-1052); our implementation
is clean-room, so its byte-level compatibility needs an EXTERNAL anchor.

libzstd (the format's reference implementation, via the ``zstandard``
module) is that anchor: these tests hand-assemble a real zstd frame whose
compressed-literals block is OUR huff0 payload (tree description + jump
table + 4 streams, zero sequences) and require libzstd to decompress it
bit-exact.  A single wrong bit anywhere — FSE weight states, weight
normalization, bitstream padding, jump-table layout — makes libzstd error
or produce different bytes, so a pass certifies the whole wire format.
"""

import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")

from minlz_jax.utils import huff0


def _zstd_frame_with_literals(payload: bytes, rsize: int) -> bytes:
    """A minimal zstd frame: one compressed block whose output is exactly
    the literals regenerated from ``payload`` (RFC 8878 §3.1.1):
    Compressed_Literals_Block (4 streams) + Number_of_Sequences == 0."""
    csize = len(payload)
    assert rsize < 1024 and csize < 1024  # 3-byte literals header, fmt 01
    frame = bytearray(b"\x28\xb5\x2f\xfd")  # magic
    # Frame_Header_Descriptor: FCS_Field_Size=2 (flag 1), Single_Segment=1
    # (no window descriptor; content must fit memory — it does).  A 2-byte
    # Frame_Content_Size carries the value minus 256 (RFC 8878 §3.1.1.1.4).
    frame.append(0x60)
    assert 256 <= rsize < 65536 + 256
    frame += (rsize - 256).to_bytes(2, "little")
    # One last block, Block_Type=2 (compressed).
    lits_hdr = 2 | (1 << 2) | (rsize << 4) | (csize << 14)  # Size_Format=01
    block = lits_hdr.to_bytes(3, "little") + payload + b"\x00"
    frame += (1 | (2 << 1) | (len(block) << 3)).to_bytes(3, "little")
    frame += block
    return bytes(frame)


def _roundtrip_via_libzstd(data: bytes) -> bytes:
    payload = huff0.compress_4x(data)
    assert payload is not None, "test data must be huff0-compressible"
    frame = _zstd_frame_with_literals(payload, len(data))
    return zstandard.ZstdDecompressor().decompress(frame), payload


def test_libzstd_decodes_our_fse_weight_table():
    """Skewed many-symbol data forces the FSE-compressed weights path;
    libzstd must regenerate the input from our payload bit-exactly."""
    rng = np.random.default_rng(42)
    # Zipf-ish skew over ~40 symbols: compressible, many distinct weights.
    syms = (rng.zipf(1.4, 900) % 40).astype(np.uint8)
    data = syms.tobytes()
    got, payload = _roundtrip_via_libzstd(data)
    assert got == data
    # header_byte < 128 means FSE-compressed weights (RFC 8878 §4.2.1.1).
    assert payload[0] < 128, "expected the FSE-compressed weights mode"


def test_libzstd_decodes_our_direct_weight_table():
    """Few-symbol data takes the direct (4-bit packed) weights path."""
    rng = np.random.default_rng(7)
    # Low symbol VALUES (0..4): the direct 4-bit table spans max_sym
    # entries, so it only beats FSE for small alphabets near zero.
    syms = rng.choice(
        np.arange(5, dtype=np.uint8), size=700,
        p=[0.5, 0.2, 0.15, 0.1, 0.05],
    )
    data = syms.tobytes()
    got, payload = _roundtrip_via_libzstd(data)
    assert got == data
    assert payload[0] >= 128, "expected the direct weights mode"


def test_libzstd_corpus_sweep():
    """Many shapes through the libzstd anchor: alphabet sizes 2..200,
    uniform and skewed, text — every frame must regenerate bit-exact."""
    rng = np.random.default_rng(3)
    twain = open("testdata/Mark.Twain-Tom.Sawyer.txt", "rb").read()
    cases = [twain[:800], twain[4000:4900]]
    for nsym in (2, 3, 8, 50, 130, 200):
        cases.append((rng.zipf(1.3, 800) % nsym).astype(np.uint8).tobytes())
    for data in cases:
        payload = huff0.compress_4x(data)
        if payload is None:
            continue  # incompressible shapes are allowed to bail
        frame = _zstd_frame_with_literals(payload, len(data))
        got = zstandard.ZstdDecompressor().decompress(frame)
        assert got == data, f"mismatch for alphabet case len={len(data)}"


def test_we_decode_libzstd_tree_description():
    """Reverse direction: extract the Huffman tree description libzstd
    writes into a real compressed frame and parse it with our
    ``read_table``; the resulting decode table must round-trip a stream
    encoded with the matching code (weights agree => codes agree)."""
    rng = np.random.default_rng(11)
    data = (rng.zipf(1.5, 4000) % 30).astype(np.uint8).tobytes()
    cctx = zstandard.ZstdCompressor(level=19)
    frame = cctx.compress(data)
    # Walk the frame to the first compressed block's literals section.
    assert frame[:4] == b"\x28\xb5\x2f\xfd"
    fhd = frame[4]
    pos = 5
    if not (fhd & 0x20):
        pos += 1  # window descriptor
    pos += (0, 2, 4, 8)[fhd >> 6] or (1 if fhd & 0x20 else 0)
    bh = int.from_bytes(frame[pos : pos + 3], "little")
    btype = (bh >> 1) & 3
    assert btype == 2, "expected a compressed block from level 19"
    pos += 3
    lh0 = frame[pos]
    assert lh0 & 3 == 2, "expected compressed literals"
    size_format = (lh0 >> 2) & 3
    if size_format in (0, 1):
        v = int.from_bytes(frame[pos : pos + 3], "little")
        rsize, csize = (v >> 4) & 1023, v >> 14
        pos += 3
    elif size_format == 2:
        v = int.from_bytes(frame[pos : pos + 4], "little")
        rsize, csize = (v >> 4) & 0x3FFF, v >> 18
        pos += 4
    else:
        v = int.from_bytes(frame[pos : pos + 5], "little")
        rsize, csize = (v >> 4) & 0x3FFFF, v >> 22
        pos += 5
    lits = frame[pos : pos + csize]
    dtable, consumed = huff0.read_table(lits)
    body = lits[consumed:]
    if size_format == 0:
        out = huff0._decode_stream(dtable, body, rsize)
    else:
        out = huff0.decode_4x_body(dtable, body, rsize)
    # The regenerated literals are a subsequence source of the block; at
    # minimum they must decode without error to exactly rsize bytes drawn
    # from the input alphabet.
    assert len(out) == rsize
    assert set(out) <= set(data)
