"""Triton transducer parse (ops/parse_triton.py) on the CPU.

The kernel runs here in the Pallas interpreter and must equal the plain
``lax.scan`` parse on all seven emission arrays.  Its GPU lowering (the
Triton IR the card compiles) is produced here too, without a card; the
compiled kernel itself is compared on the card by ``chip_smoke.py`` and
``tests/test_gpu_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minlz_jax.ops import executor as ex
from minlz_jax.ops.decode_kernel import parse_segments_scan
from minlz_jax.ops.parse_triton import LANE_BLOCK, parse_segments_triton

from conftest import load_corpus


def _pack(streams, lanes=None):
    lanes = lanes or LANE_BLOCK * -(-len(streams) // LANE_BLOCK)
    n_rows = ex.row_bucket(max(len(s) for s in streams) + 1)
    comp = np.zeros((n_rows, lanes), np.uint8)
    lens = np.zeros(lanes, np.int32)
    for i, s in enumerate(streams):
        comp[: len(s), i] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return comp, lens


def _golden_streams():
    from minlz_jax.oracle.decode import parse_header

    mzb = open("testdata/Mark.Twain-Tom.Sawyer.txt.mzb", "rb").read()
    _, _, pos = parse_header(mzb)
    return [mzb[pos:]]


def _device_segment_streams():
    from minlz_jax.ops.device_codec import DeviceCodec, parse_hints, split_body
    from minlz_jax.oracle.decode import parse_header

    twain = open("testdata/Mark.Twain-Tom.Sawyer.txt", "rb").read()
    rng = np.random.default_rng(5)
    data = (twain[:20000] + rng.integers(0, 256, 6000, dtype=np.uint8)
            .tobytes() + bytes(9000) + twain[5000:40000])
    block, hints = DeviceCodec().encode(data)
    _, _, pos = parse_header(block)
    _, offs, _ = parse_hints(hints)
    return split_body(block[pos:], offs)


def _fuzz_corpus_streams():
    from minlz_jax.oracle import encode as oenc
    from minlz_jax.oracle.decode import parse_header

    out = []
    for data in load_corpus("block-corpus-enc.zip"):
        if not 64 <= len(data) <= 8192:
            continue
        block = oenc.encode_block(data)
        lit_only, want, pos = parse_header(block)
        if lit_only or want == 0:
            continue
        out.append(block[pos:])
        if len(out) == 40:
            break
    return out


@pytest.mark.parametrize(
    "streams",
    [_golden_streams, _device_segment_streams, _fuzz_corpus_streams],
    ids=["golden", "device_segments", "fuzz_corpus"],
)
def test_triton_parse_matches_scan(streams):
    comp, lens = _pack(streams())
    want = parse_segments_scan(jnp.asarray(comp.astype(np.int32)),
                               jnp.asarray(lens))
    got = parse_segments_triton(jnp.asarray(comp), jnp.asarray(lens),
                                interpret=True)
    assert len(got) == 7
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_triton_parse_rejects_ragged_lanes():
    comp, lens = _pack(_golden_streams(), lanes=LANE_BLOCK + 8)
    with pytest.raises(ValueError):
        parse_segments_triton(jnp.asarray(comp), jnp.asarray(lens),
                              interpret=True)


def test_triton_parse_lowers_for_cuda():
    """The kernel lowers to one Triton call for the GPU, at real width
    (1,024 lanes) and a row count that is not a power of two."""
    low = parse_segments_triton.trace(
        jax.ShapeDtypeStruct((6144, 1024), jnp.uint8),
        jax.ShapeDtypeStruct((1024,), jnp.int32),
    ).lower(lowering_platforms=("cuda",))
    assert low.as_text().count("xla.gpu.triton") == 1


@pytest.mark.parametrize("platform,calls", [("cuda", 1), ("cpu", 0)])
def test_decode_picks_parse_by_platform(platform, calls):
    """The fused decode parses through Triton when lowered for CUDA and
    through lax.scan elsewhere."""
    lanes = 64
    args = [jax.ShapeDtypeStruct((lanes, 512), jnp.uint8)]
    args += [jax.ShapeDtypeStruct((lanes,), jnp.int32)] * 5
    args += [jax.ShapeDtypeStruct((2,), jnp.int32)]
    low = ex.decode_batch_device.trace(
        *args, nblk=2, block_out=1 << 17
    ).lower(lowering_platforms=(platform,))
    assert low.as_text().count("xla.gpu.triton") == calls
