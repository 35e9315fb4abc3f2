"""LZ4 conversion tests: differential vs decompress-then-recompress."""

import numpy as np
import pytest

from minlz_jax import lz4
from minlz_jax.oracle import decode as odec

from conftest import load_corpus


def test_lz4_mini_codec_roundtrip(twain):
    enc = lz4.lz4_encode_block(twain)
    assert len(enc) < len(twain)
    assert lz4.lz4_decode_block(enc) == twain


def test_convert_block_twain(twain):
    enc = lz4.lz4_encode_block(twain)
    mlz = lz4.convert_block(enc)
    assert odec.decode_block(mlz) == twain
    # Conversion should not be drastically larger than the LZ4 input.
    assert len(mlz) <= len(enc) * 1.05


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_convert_block_mixed(twain, seed):
    rng = np.random.default_rng(seed)
    data = (
        twain[:4000]
        + rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()
        + twain[:4000]
        + b"x" * 500
    )
    enc = lz4.lz4_encode_block(data)
    assert lz4.lz4_decode_block(enc) == data
    mlz = lz4.convert_block(enc)
    assert odec.decode_block(mlz) == data


def test_convert_corpus():
    """Round-trip corpus inputs through lz4-encode -> convert -> decode."""
    n = 0
    for data in load_corpus("FuzzLZ4Block.zip"):
        if len(data) < 16 or len(data) > 100_000:
            continue
        enc = lz4.lz4_encode_block(data)
        if lz4.lz4_decode_block(enc) != data:
            continue
        mlz = lz4.convert_block(enc)
        assert odec.decode_block(mlz) == data
        n += 1
        if n >= 15:
            break
    assert n >= 5


def test_corrupt_lz4_rejected():
    with pytest.raises(lz4.LZ4CorruptError):
        lz4.convert_block(b"\xff\x01\x02")  # truncated literal ext
    with pytest.raises(lz4.LZ4CorruptError):
        # offset beyond output
        lz4.convert_block(bytes([1 << 4]) + b"A" + b"\x10\x00" + b"\x00")


def test_lz4_frame_conversion(twain):
    """Build an LZ4 frame by hand, convert it to a MinLZ stream, decode."""
    import io

    from minlz_jax.lz4 import LZ4_FRAME_MAGIC, convert_frame, lz4_encode_block
    from minlz_jax.stream import Reader, Writer

    data = twain * 6
    bs = 64 << 10
    frame = bytearray(LZ4_FRAME_MAGIC)
    frame.append(0x60)  # version 01, block independence, no checksums/size
    frame.append(0x40)  # BD: 64KB max block
    frame.append(0)     # header checksum (not validated by the converter)
    for i in range(0, len(data), bs):
        blk = lz4_encode_block(data[i : i + bs])
        frame += len(blk).to_bytes(4, "little")
        frame += blk
    frame += (0).to_bytes(4, "little")  # EndMark

    buf = io.BytesIO()
    w = Writer(buf, block_size=bs, add_index=False)
    n = convert_frame(bytes(frame), w)
    w.close()
    assert n == len(data)
    assert Reader(io.BytesIO(buf.getvalue())).readall() == data


def test_lz4_frame_dependent_blocks_rejected(twain):
    from minlz_jax.lz4 import LZ4_FRAME_MAGIC, LZ4CorruptError, parse_lz4_frame

    frame = bytes(LZ4_FRAME_MAGIC) + bytes([0x40, 0x40, 0]) + b"\x00" * 4
    try:
        list(parse_lz4_frame(frame))
        raise AssertionError("dependent frame accepted")
    except LZ4CorruptError:
        pass


def test_convert_block_native_differential(twain):
    """The C++ converter (cvtLZ4BlockAsm analog) must emit byte-identical
    MinLZ blocks to the pure-Python walker on every input shape."""
    from minlz_jax.native.codec import get_codec

    if get_codec() is None or not hasattr(
        get_codec()._lib, "minlz_lz4_convert_block"
    ):
        import pytest

        pytest.skip("native codec unavailable")
    import numpy as np

    rng = np.random.default_rng(7)
    cases = [
        lz4.lz4_encode_block(twain),
        lz4.lz4_encode_block(twain[:100]),
        lz4.lz4_encode_block(rng.integers(0, 256, 5000,
                                          dtype=np.uint8).tobytes()),
        lz4.lz4_encode_block(b"A" * 10000),
        lz4.lz4_encode_block(bytes(rng.integers(65, 70, 20000,
                                                dtype=np.uint8))),
    ]
    for enc in cases:
        assert lz4.convert_block(enc, native=True) == lz4.convert_block(
            enc, native=False
        )
