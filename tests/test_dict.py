"""Dictionary compression tests."""

import pytest

from minlz_jax.dict import Dict, decode_with_dict, encode_with_dict
from minlz_jax.oracle import encode as oenc


def test_dict_roundtrip_and_gain(twain):
    d = Dict(twain[:8000])
    data = twain[6000:14000]
    enc = encode_with_dict(data, d)
    assert decode_with_dict(enc, d) == data
    # Dictionary overlap must beat dict-less encoding.
    assert len(enc) < len(oenc.encode_block(data))


def test_dict_disjoint_content(twain):
    d = Dict(b"\x01\x02\x03\x04" * 64)
    data = twain[:5000]
    enc = encode_with_dict(data, d)
    assert decode_with_dict(enc, d) == data


def test_dict_size_limits():
    with pytest.raises(ValueError):
        Dict(b"short")
    with pytest.raises(ValueError):
        Dict(b"x" * 70000)


@pytest.mark.parametrize("level", [-1, 1, 2, 3])
def test_dict_levels_beat_nondict(twain, level):
    """Dict-aware optimal parse at every level: beats the same-level
    non-dict encode and round-trips via both oracle and native decoders."""
    from minlz_jax import block as blockapi
    from minlz_jax.native.codec import get_codec

    d = Dict(twain[:8192])
    data = twain[4096:]
    enc = encode_with_dict(data, d, level=level)
    assert decode_with_dict(enc, d) == data
    codec = get_codec()
    if codec is not None:
        assert codec.decode_block_dict(enc, d.bytes) == data
    assert len(enc) < len(blockapi.encode(data, level=level))


def test_dict_level_ladder(twain):
    """Higher levels never produce larger dict-encoded output."""
    d = Dict(twain[:8192])
    data = twain[4096:]
    sizes = [len(encode_with_dict(data, d, level=lv)) for lv in (-1, 1, 2, 3)]
    assert sizes == sorted(sizes, reverse=True) or len(set(sizes)) < 4


def test_dict_marshal(twain):
    d = Dict(twain[:1000])
    assert Dict.load(d.marshal()).bytes == d.bytes


def test_dict_tiny_input(twain):
    d = Dict(twain[:100])
    for data in (b"", b"abc", twain[:20]):
        enc = encode_with_dict(data, d)
        assert decode_with_dict(enc, d) == data


def test_mesh_dict_broadcast_encode():
    """Dictionary broadcast over the mesh (replicated sharding): blocks
    encode against the shared dict, copies reach into it, and the result
    decodes bit-exact with the dict-seeded decoder.  SURVEY §2.14 dict
    broadcast / reference encode_l2.go:607 dict-candidate analog."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from minlz_jax.minlz import put_uvarint
    from minlz_jax.native.codec import get_codec
    from minlz_jax.parallel import make_mesh, sharded_encode_blocks_dict

    codec = get_codec()
    if codec is None:
        import pytest

        pytest.skip("native codec unavailable")

    twain = open("testdata/Mark.Twain-Tom.Sawyer.txt", "rb").read()
    seg = 4096
    D = 8 * seg  # 32 KiB dict, front-padded region included
    dict_bytes = (twain * 4)[:D]
    ndev = min(4, len(jax.devices()))
    mesh = make_mesh(jax.devices()[:ndev])
    nb = ndev * 2
    N = 8 * seg
    rng = np.random.default_rng(3)
    blocks = np.zeros((nb, N), np.int32)
    raws = []
    for b in range(nb):
        # shares vocabulary with the dict; light mutations
        d = bytearray((twain[b * 131 :] + twain * 4)[:N])
        for _ in range(64):
            d[int(rng.integers(0, N))] = int(rng.integers(32, 127))
        raws.append(bytes(d))
        blocks[b] = np.frombuffer(bytes(d), np.uint8)
    valid = jnp.full((nb,), N, jnp.int32)
    dict_arr = jnp.asarray(np.frombuffer(dict_bytes, np.uint8), jnp.int32)

    seg_bytes, seg_lens, sizes, offs = sharded_encode_blocks_dict(
        mesh, dict_arr, jnp.asarray(blocks), valid, seg
    )
    seg_bytes = np.asarray(seg_bytes)
    seg_lens = np.asarray(seg_lens)
    sizes = np.asarray(sizes)
    offs = np.asarray(offs)
    assert (np.diff(offs) == sizes[:-1]).all()

    from minlz_jax.ops.emit import encode_block_emit

    for b in range(nb):
        body = b"".join(
            seg_bytes[b, i, : seg_lens[b, i]].tobytes()
            for i in range(seg_lens.shape[1])
        )
        blk = b"\x00" + put_uvarint(N) + body
        got = codec.decode_block_dict(blk, dict_bytes)
        assert got == raws[b], f"block {b} dict decode mismatch"
        # dict must help: compare against the same emit path without dict
        out_nd, lens_nd = encode_block_emit(
            jnp.asarray(blocks[b])[None, :], N, seg, 0
        )
        no_dict = int(np.asarray(lens_nd).sum())
        assert sizes[b] <= no_dict, (sizes[b], no_dict)
    assert (sizes < np.array([len(r) for r in raws])).all()
