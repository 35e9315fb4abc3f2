"""Plain-XLA decode executor (ops/executor.py) correctness tests.

The micro-tests drive the record-level entry point ``execute_records``
against a known byte ramp: literal reads at every alignment and length,
copies at every overlap mode, zero-literal and row-crossing records.  The
oracle-differential round-trips run the whole device decode (parse +
execute) on single- and multi-block batches, under hints v2 (range clamp)
and v1 (copies anywhere earlier in the block), and hostile records must
raise CorruptError instead of decoding.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from minlz_jax.minlz import CorruptError
from minlz_jax.ops import executor as ex
from minlz_jax.ops.encode_kernel import RANGE

# Micro-test geometry: a 2 KiB byte ramp as the literal source, 2 KiB of
# output.  ROW is the old arena row width, kept so literal sources sit at
# the same global offsets the cases were written for.
ROW = 512
COMP_ROWS, OUT_ROWS = 4, 4
COMP = (np.arange(COMP_ROWS * ROW, dtype=np.uint32) % 251).astype(np.uint8)


def run_ops(op_list):
    """Execute consecutive records against the byte ramp.

    op_list entries: (llen, clen, csrc, lsrc_global_byte), where the ramp
    starts at global byte ROW.  Returns the decoded output bytes.
    """
    n = len(op_list)
    llen, clen, csrc, lsrc = (
        np.array([op[i] for op in op_list], np.int32) for i in range(4)
    )
    start = np.concatenate([[0], np.cumsum(llen + clen)[:-1]]).astype(np.int32)
    out, bad, lost, _ = ex.execute_records(
        jnp.asarray(COMP),
        jnp.asarray(start),
        jnp.asarray(llen),
        jnp.asarray(clen),
        jnp.asarray(csrc),
        jnp.asarray(lsrc - ROW),
        jnp.zeros(n, jnp.int32),
        jnp.ones(n, bool),
        OUT_ROWS * ROW,
    )
    used = int((llen + clen).sum())
    assert not np.asarray(bad)[:used].any()
    assert not np.asarray(lost).any()
    return np.asarray(out)


@pytest.mark.parametrize("align", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("llen", [1, 3, 26, 511, 513])
def test_literal_alignment_sweep(align, llen):
    """Literal reads at every byte alignment and across row widths."""
    ls = ROW + align  # global byte address of the literal source
    got = run_ops([(llen, 0, 0, ls)])
    want = COMP[align : align + llen]
    assert (got[:llen] == want).all(), (align, llen)


@pytest.mark.parametrize(
    "offset,clen",
    [(1, 5), (1, 100), (2, 37), (3, 64), (7, 29), (64, 200), (300, 513)],
)
def test_copy_offsets(offset, clen):
    """Copies incl. RLE overlap (offset < length): pointer chains longer
    than one doubling round."""
    seed = max(64, offset)  # copy source must stay inside the output
    got = run_ops([(seed, clen, offset, ROW)])
    want = bytearray(COMP[:seed])
    for _ in range(clen):
        want.append(want[-offset])
    assert bytes(got[: seed + clen]) == bytes(want)


def test_copy_zero_literal_op():
    """A record with no literals runs its copy at its own start."""
    got = run_ops([(16, 0, 0, ROW), (0, 8, 4, ROW)])
    want = bytearray(COMP[:16])
    for _ in range(8):
        want.append(want[-4])
    assert bytes(got[:24]) == bytes(want)


def test_row_crossing_literal_then_copy():
    """A literal run crossing a 512B boundary must finish before its own
    record's copy starts."""
    got = run_ops([(500, 0, 0, ROW), (30, 40, 10, ROW + 500)])
    want = bytearray(COMP[:530])
    for _ in range(40):
        want.append(want[-10])
    assert bytes(got[:570]) == bytes(want)


def _encode_segs(data, seg, rng):
    from minlz_jax.oracle import decode as odec
    from minlz_jax.ops.device_codec import split_body
    from minlz_jax.ops.encode_kernel import encode_block_device

    block, hints = encode_block_device(data, seg, rng)
    assert odec.decode_block(block) == data
    _, _, pos = odec.parse_header(block)
    return split_body(block[pos:], [h[0] for h in hints])


def _roundtrip(nkb: int, rng: int = RANGE):
    twain = open("testdata/Mark.Twain-Tom.Sawyer.txt", "rb").read()
    data = (twain * 40)[: nkb << 10]
    segs = _encode_segs(data, 4096, rng)
    assert ex.decode_blocks([segs], [len(data)], 4096) == [data]


def test_differential_roundtrip_single_chain():
    _roundtrip(32)  # 8 segments inside one range


def test_differential_roundtrip_multi_chain():
    _roundtrip(160)  # 40 segments over two 128 KiB ranges


def test_batched_multi_block_decode():
    """Several blocks of mixed sizes through one dispatch: per-block
    outputs stay bit-exact and copies never cross blocks."""
    twain = open("testdata/Mark.Twain-Tom.Sawyer.txt", "rb").read()
    rng_np = np.random.default_rng(3)
    seg = 4096
    blocks = [
        (twain * 40)[: 160 << 10],                      # text, 40 segs
        rng_np.integers(0, 16, 96 << 10, dtype=np.uint8).tobytes(),
        (twain * 40)[13:][: 64 << 10],                  # different phase
        bytes(48 << 10),                                # RLE zeros
    ]
    segs = [_encode_segs(b, seg, RANGE) for b in blocks]
    got = ex.decode_blocks(segs, [len(b) for b in blocks], seg)
    for g, b in zip(got, blocks):
        assert g == b


def test_v1_copy_across_segments_beyond_128k():
    """Hints v1 (no range clamp): copies reach more than 128 KiB back,
    across segments, and still decode bit-exact."""
    from minlz_jax.oracle import encode as oenc

    rng_np = np.random.default_rng(11)
    seg = 4096
    head = rng_np.integers(0, 256, 3 * seg, dtype=np.uint8).tobytes()
    filler = rng_np.integers(0, 256, 40 * seg, dtype=np.uint8).tobytes()
    data = head + filler + head  # the tail copies 172 KiB back
    segs = []
    for i in range(0, len(head) + len(filler), seg):
        s = bytearray()
        oenc.emit_literals(s, data[i : i + seg])
        segs.append(bytes(s))
    dist = len(head) + len(filler)
    assert dist > 128 << 10
    for i in range(3):
        s = bytearray()
        oenc.emit_copy3(s, dist, seg)
        segs.append(bytes(s))
    assert ex.decode_blocks([segs], [len(data)], seg) == [data]


def test_hostile_copy_before_block_start_raises():
    """A record whose copy source precedes its block is flagged, and the
    codec raises CorruptError — also when an earlier block of the batch
    could serve the read."""
    from minlz_jax.oracle import encode as oenc
    from minlz_jax.ops.device_codec import DeviceCodec, marshal_hints

    seg = 4096
    s0 = bytearray()
    oenc.emit_literals(s0, b"ab" * 8)
    oenc.emit_copy2(s0, 100, 64)  # reads 84 bytes before the block
    good = bytearray()
    oenc.emit_literals(good, bytes(range(200)))
    n_bad = 16 + 64
    got = ex.decode_blocks([[bytes(good)], [bytes(s0)]], [200, n_bad], seg)
    assert got[0] == bytes(range(200))
    assert got[1] is None
    with pytest.raises(CorruptError):
        DeviceCodec().decode(bytes(s0), marshal_hints(seg, [(0, 0)]), n_bad)


def test_seg8192_whole_literal_record():
    """seg = 8192 with a wholly-literal segment: llen = 8192 and lsrc >
    8191 in the second segment."""
    from minlz_jax.oracle import encode as oenc

    seg = 8192
    rng_bytes = (np.arange(seg, dtype=np.uint32) * 2654435761 >> 13).astype(
        np.uint8
    ).tobytes()  # incompressible-ish ramp
    s0 = bytearray()
    oenc.emit_literals(s0, rng_bytes)  # one op, llen = 8192
    twain = open("testdata/Mark.Twain-Tom.Sawyer.txt", "rb").read()
    s1 = bytearray()
    # Literal-heavy second segment so its lsrc cursor passes 8191 too.
    oenc.emit_literals(s1, twain[:seg])
    data = rng_bytes + twain[:seg]
    got = ex.decode_blocks([[bytes(s0), bytes(s1)]], [len(data)], seg)
    assert got == [data]


def test_seg8192_device_roundtrip():
    """End-to-end device encode/decode at seg = 8192 (the DeviceCodec
    geometry for 2-4 MiB blocks), mixing incompressible and text data."""
    rng = np.random.default_rng(7)
    twain = open("testdata/Mark.Twain-Tom.Sawyer.txt", "rb").read()
    data = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes() + (
        twain * 2
    )[: 3 * 8192]
    segs = _encode_segs(data, 8192, RANGE)
    assert ex.decode_blocks([segs], [len(data)], 8192) == [data]


def test_uncovered_bytes_are_flagged():
    """Bytes no record reaches (a record stops short) are flagged, and
    records claiming one start are reported lost."""
    out, bad, lost, _ = ex.execute_records(
        jnp.asarray(COMP),
        jnp.asarray(np.array([0, 10, 10], np.int32)),
        jnp.asarray(np.array([8, 4, 4], np.int32)),
        jnp.zeros(3, jnp.int32),
        jnp.zeros(3, jnp.int32),
        jnp.zeros(3, jnp.int32),
        jnp.zeros(3, jnp.int32),
        jnp.ones(3, bool),
        16,
    )
    bad = np.asarray(bad)
    assert not bad[:8].any() and bad[8:10].all() and bad[14:].all()
    assert np.asarray(lost).sum() == 1


def test_truncated_segment_is_corrupt():
    """A segment stream cut inside a literal run cannot fill its segment:
    the device flags the block."""
    from minlz_jax.oracle import encode as oenc

    s = bytearray()
    oenc.emit_literals(s, bytes(range(100)))
    assert ex.decode_blocks([[bytes(s[:50])]], [100], 4096) == [None]


@pytest.mark.parametrize(
    "n,want", [(1, 256), (256, 256), (257, 384), (385, 512), (4097, 6144),
               (6145, 8192)]
)
def test_row_bucket(n, want):
    """Row buckets: 2^k or 3 * 2^(k-1), at least 256."""
    assert ex.row_bucket(n) == want


def test_plan_batch_geometry():
    """Lanes pad to a power of two (at least one Triton lane block), blocks
    to a power of two, and each lane's output base follows its block."""
    segs = [[b"\x00" * 10] * 3, [b"\x00" * 20]]
    (comp, lens, base, lo, seglen, blk, blk_len), st = ex.plan_batch(
        segs, [3 * 4096 - 5, 100], 4096
    )
    assert comp.shape == (32, 256) and comp.dtype == np.uint8
    assert st == dict(nblk=2, block_out=16384)
    assert list(lens[:5]) == [10, 10, 10, 20, 0]
    assert list(base[:4]) == [0, 4096, 8192, 16384]
    assert list(lo[:4]) == [0, 0, 0, 16384]
    assert list(seglen[:5]) == [4096, 4096, 4091, 100, 0]
    assert list(blk[:4]) == [0, 0, 0, 1]
    assert list(blk_len) == [3 * 4096 - 5, 100]


def test_plan_batch_rejects_bad_hints():
    """Segment counts that do not match the block, and streams far longer
    than a segment can need, are corrupt hints."""
    with pytest.raises(CorruptError):
        ex.plan_batch([[b"", b""]], [100], 4096)
    with pytest.raises(CorruptError):
        ex.plan_batch([[b"\x00" * 9300]], [4096], 4096)
