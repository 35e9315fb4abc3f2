"""Device encode/decode pipeline tests (XLA on the CPU here)."""

import io

import numpy as np
import pytest

from minlz_jax.oracle import decode as odec
from minlz_jax.ops.device_codec import marshal_hints, parse_hints, split_body
from minlz_jax.ops.encode_kernel import encode_block_device
from minlz_jax.ops.executor import decode_blocks
from minlz_jax.stream import Reader, Writer


@pytest.mark.parametrize(
    "payload", [b"MZP", b"MZPH", b"MZPH\x02\x80", b"MZPH\x01\x80\x20\x03\x05"],
    ids=["short_magic", "no_version", "truncated_seg", "truncated_offsets"],
)
def test_truncated_hints_are_corrupt(payload):
    """A hint payload cut anywhere raises CorruptError (the Reader's cue to
    decode the block on the host), never another exception."""
    from minlz_jax.minlz import CorruptError

    with pytest.raises(CorruptError):
        parse_hints(payload)


def test_hint_wire_roundtrip():
    hints = [(0, 0), (100, 4096), (250, 8192), (1000, 12288)]
    payload = marshal_hints(4096, hints)
    seg, offs, rng = parse_hints(payload)
    assert seg == 4096
    assert offs == [h[0] for h in hints]
    assert rng == 0
    payload2 = marshal_hints(4096, hints, rng=131072)
    seg2, offs2, rng2 = parse_hints(payload2)
    assert (seg2, offs2, rng2) == (4096, offs, 131072)


def test_device_encode_oracle_decodable(twain):
    """Device-encoded blocks are plain MinLZ: the spec oracle decodes them."""
    block, hints = encode_block_device(twain)
    assert odec.decode_block(block) == twain
    assert hints[0][0] == 0


def test_device_roundtrip_mixed(twain):
    rng = np.random.default_rng(3)
    data = (
        twain[:6000]
        + rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
        + twain[:8000]
        + b"A" * 3000
        + bytes(rng.integers(0, 4, 2000, dtype=np.uint8))
    )
    block, hints = encode_block_device(data)
    assert odec.decode_block(block) == data
    _, want, pos = odec.parse_header(block)
    body = block[pos:]
    segs = split_body(body, [h[0] for h in hints])
    assert decode_blocks([segs], [len(data)], 4096) == [data]


def test_device_levels_monotone(twain):
    """Device levels trade speed for ratio (reference encode_l0..l3
    analogs): every level round-trips through the oracle, and ratio
    improves monotonically from -1 through 3 (small slack — greedy parses
    with richer candidate sets are not strictly dominant per block)."""
    data = (twain * 10)[: 96 << 10]
    sizes = {}
    for level in (-1, 1, 2, 3):
        block, hints = encode_block_device(data, 4096, 0, level)
        assert odec.decode_block(block) == data, level
        sizes[level] = len(block)
    assert sizes[-1] > sizes[2]  # fast level clearly trades ratio away
    for lo, hi in ((-1, 1), (1, 2), (2, 3)):
        assert sizes[hi] <= sizes[lo] * 1.005, sizes
    # Absolute watermarks (ratcheted every round; r5 = proposal-DP +
    # local-chain L3 serializer): regressions in the device match finder
    # or serializer must not drift past these.
    assert sizes[1] <= 9280, sizes
    assert sizes[3] <= 8850, sizes


def test_device_ratio_vs_reference_golden(twain):
    """Reference-encoder anchor for the device path: the golden block
    (testdata/*.mzb, produced by the Go reference encoder) compresses
    Twain to 8875 bytes.  Device L3 (device proposals + segment beam DP,
    native dp_segment) must BEAT the golden outright (measured 8681);
    device L2's greedy parse stays within 4% (it trades ratio for
    segment-parallel decode; the host optimal-parse levels beat the
    golden too, tests/test_oracle.py::test_ratio_per_level)."""
    golden = open("testdata/Mark.Twain-Tom.Sawyer.txt.mzb", "rb").read()
    block2, _ = encode_block_device(twain, 4096, 0, 2)
    assert odec.decode_block(block2) == twain
    assert len(block2) <= len(golden) * 1.04, (len(block2), len(golden))
    block3, _ = encode_block_device(twain, 4096, 0, 3)
    assert odec.decode_block(block3) == twain
    assert len(block3) <= len(golden), (len(block3), len(golden))


def test_device_decode_spec_max_block(twain):
    """A block spanning several hint ranges (and more lanes than one
    block of the parse grid) decodes on the device in one dispatch."""
    from minlz_jax.ops.device_codec import DeviceCodec

    dc = DeviceCodec()
    data = (twain * 60)[: 640 << 10]
    r = dc.encode(data)
    assert r is not None
    block, hints = r
    _, want, pos = odec.parse_header(block)
    got = dc.decode(block[pos:], hints, len(data))
    assert got == data


def test_device_batch_decode_api(twain):
    """DeviceCodec.decode_batch: multiple hinted blocks in one call."""
    from minlz_jax.ops.device_codec import DeviceCodec

    dc = DeviceCodec()
    blocks = [(twain * 10)[: 48 << 10], (twain * 7)[7:][: 32 << 10]]
    items = []
    for b in blocks:
        block, hints = dc.encode(b)
        _, want, pos = odec.parse_header(block)
        items.append((block[pos:], hints, len(b)))
    outs = dc.decode_batch(items)
    for got, want_b in zip(outs, blocks):
        assert got == want_b


def test_device_stream_roundtrip(twain):
    data = twain * 20
    buf = io.BytesIO()
    with Writer(buf, device=True, block_size=128 << 10, concurrency=1) as w:
        w.encode_buffer(data)
    enc = buf.getvalue()
    assert len(enc) < len(data)
    # Device reader (uses hints).
    assert Reader(io.BytesIO(enc), device=True).readall() == data
    # Plain reader must also decode the same stream (hints are skippable).
    assert Reader(io.BytesIO(enc)).readall() == data


def test_device_emit_stream_roundtrip(twain):
    """Writer(device_emit=True): ALL serialization on device (ops/emit.py)
    — no host serializer in the loop; the stream must stay spec-valid and
    device-decodable (hints v2 from the emit path)."""
    data = (twain * 12)[: 160 << 10]
    buf = io.BytesIO()
    with Writer(
        buf, device=True, device_emit=True, block_size=64 << 10,
        concurrency=1,
    ) as w:
        w.encode_buffer(data)
    enc = buf.getvalue()
    assert Reader(io.BytesIO(enc)).readall() == data          # host decode
    assert Reader(io.BytesIO(enc), device=True).readall() == data


def test_device_stream_incompressible():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, 200_000, dtype=np.uint8).tobytes()
    buf = io.BytesIO()
    with Writer(buf, device=True, block_size=64 << 10, concurrency=1) as w:
        w.encode_buffer(data)
    enc = buf.getvalue()
    assert Reader(io.BytesIO(enc), device=True).readall() == data


def test_sharded_decode_parse_matches_unsharded(twain):
    """Mesh-sharded transducer parse == per-block unsharded parse, with
    deterministic global op offsets from the collective scan."""
    import jax
    import numpy as np

    from minlz_jax.oracle import encode as oenc
    from minlz_jax.oracle.decode import parse_header
    from minlz_jax.ops.decode_kernel import pack_segments, parse_segments_scan
    from minlz_jax.parallel import make_mesh, sharded_decode_parse

    n_dev = len(jax.devices())
    nblocks = n_dev * 2
    segs = []
    for i in range(nblocks):
        data = twain[i * 400 : i * 400 + 3000]
        enc = oenc.encode_block(data)
        lit_only, want, pos = parse_header(enc)
        assert not lit_only
        segs.append(enc[pos:])
    P = 1 << max(len(s) for s in segs).bit_length()
    S = 4
    mat = np.zeros((nblocks, P, S), np.int32)
    lens = np.zeros((nblocks, S), np.int32)
    for i, s in enumerate(segs):
        a = np.frombuffer(s, np.uint8)
        mat[i, : len(a), 0] = a
        lens[i, 0] = len(a)

    mesh = make_mesh()
    out = sharded_decode_parse(mesh, mat, lens)
    offs = np.asarray(out[-1])
    kinds = np.asarray(out[0])
    ops_per_block = (kinds > 0).sum(axis=(1, 2))
    assert (np.diff(offs) == ops_per_block[:-1]).all()
    # Differential vs unsharded parse of block 0.
    m0, l0 = pack_segments([segs[0]])
    ref = parse_segments_scan(np.asarray(m0), np.asarray(l0))
    got_kind = kinds[0][: ref[0].shape[0], :1]
    assert (np.asarray(ref[0]) == got_kind).all()


def test_sharded_encode_pipeline_roundtrip(twain):
    """The mesh encode step's sharded parse must serialize into valid
    MinLZ blocks, and its collective size-scan must be consistent."""
    import jax
    import numpy as np

    from minlz_jax.minlz import put_uvarint
    from minlz_jax.oracle import decode as odec
    from minlz_jax.ops.encode_kernel import serialize_block
    from minlz_jax.parallel import make_mesh, sharded_pipeline_step

    n_dev = len(jax.devices())
    nb = n_dev * 2
    bs = 16384
    seg = 4096
    rng = np.random.default_rng(21)
    blocks = []
    for i in range(nb):
        start = int(rng.integers(0, len(twain) - 4000))
        blocks.append((twain[start : start + 4000] * 8)[:bs])
    data = np.zeros((nb, bs), np.int32)
    for i, b in enumerate(blocks):
        data[i] = np.frombuffer(b, np.uint8)
    valid = np.full((nb,), bs, np.int32)

    mesh = make_mesh()
    take, tok_off, tok_len, est, offs = sharded_pipeline_step(
        mesh, data, valid, seg
    )
    take = np.asarray(take)
    tok_off = np.asarray(tok_off)
    tok_len = np.asarray(tok_len)
    offs = np.asarray(offs)
    est = np.asarray(est)
    assert (np.diff(offs) == est[:-1]).all()

    # Serialize each block from the sharded parse and roundtrip-check.
    for i, b in enumerate(blocks):
        pos = np.nonzero(take[i].reshape(-1))[0].astype(np.int32)
        offv = tok_off[i].reshape(-1)[pos]
        lnv = tok_len[i].reshape(-1)[pos]
        isrep = np.zeros_like(pos)
        body, hints = serialize_block(
            b, pos, offv, lnv, isrep, len(pos), seg
        )
        blk = b"\x00" + put_uvarint(len(b)) + body
        assert odec.decode_block(blk) == b, f"block {i}"


def test_device_roundtrip_fuzz(twain):
    """Randomized structure fuzz through the full device encode+decode
    pipeline (reference FuzzEncodingBlocks analog for the device path)."""
    import numpy as np

    from minlz_jax.minlz import read_uvarint
    from minlz_jax.ops.device_codec import get_device_codec, parse_hints, split_body
    from minlz_jax.ops.executor import decode_blocks

    rng = np.random.default_rng(99)
    codec = get_device_codec()
    cases = []
    for trial in range(12):
        kind = trial % 6
        n = int(rng.integers(5000, 90000))
        if kind == 0:  # random bytes (incompressible)
            d = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        elif kind == 1:  # runs (RLE-heavy)
            d = b"".join(
                bytes([int(rng.integers(0, 5))]) * int(rng.integers(1, 300))
                for _ in range(n // 50)
            )[:n]
        elif kind == 2:  # text
            s = int(rng.integers(0, len(twain) - 1000))
            d = (twain[s : s + 1000] * 100)[:n]
        elif kind == 3:  # periodic short
            d = (bytes(range(7)) * (n // 7 + 1))[:n]
        elif kind == 4:  # structured ints
            a = rng.integers(0, 1 << 16, n // 4 + 1).astype(np.uint32)
            a.sort()
            d = a.tobytes()[:n]
        else:  # mixed
            d = (twain[:500] + rng.integers(0, 256, 500, dtype=np.uint8).tobytes()) * (n // 1000 + 1)
            d = d[:n]
        cases.append(d)

    for i, d in enumerate(cases):
        res = codec.encode(d)
        if res is None:
            continue  # incompressible: stream layer stores raw
        block, hint_payload = res
        _, p = read_uvarint(block, 1)
        seg_size, offs, _ = parse_hints(hint_payload)
        segs = split_body(block[p:], offs)
        out = decode_blocks([segs], [len(d)], seg_size)[0]
        assert out == d, f"case {i} ({len(d)}B) device roundtrip mismatch"
