"""Device token emission (ops/emit.py) tests.

The emitter must (a) round-trip through the spec oracle on varied corpora,
(b) match the host serializer byte-for-byte given identical verified token
arrays, and (c) produce bit-exact blocks end-to-end under the sharded mesh
path (see also __graft_entry__.dryrun_multichip).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from minlz_jax.minlz import put_uvarint
from minlz_jax.ops import emit
from minlz_jax.ops import encode_kernel as ek
from minlz_jax.oracle import decode as odec

SEG = 4096
WIN2 = 2 * ek.WINDOW


def _pad(data: bytes):
    n = len(data)
    N = -(-max(n, 1) // SEG) * SEG
    N = -(-N // WIN2) * WIN2
    flat = np.zeros((1, N), np.int32)
    flat[0, :n] = np.frombuffer(data, np.uint8)
    return jnp.asarray(flat), n


def _device_encode(data: bytes):
    flat, n = _pad(data)
    out, lens = emit.encode_block_emit(flat, n, SEG)
    out, lens = np.asarray(out), np.asarray(lens)
    nseg = -(-n // SEG)
    assert (lens[nseg:] == 0).all()
    body = b"".join(out[i, : lens[i]].tobytes() for i in range(nseg))
    return body, lens[:nseg]


CORPORA = {
    "text": lambda t, r: (t * 6)[: 64 * 1024],
    "runs": lambda t, r: (b"abcabc" * 150 + bytes(400) + b"zz" * 600) * 16,
    "lowent": lambda t, r: r.integers(0, 8, 64 * 1024, np.uint8).tobytes(),
    "partial_tail": lambda t, r: (t * 2)[:20000],
    "json": lambda t, r: b"".join(
        b'{"k":%d,"v":"%s"}\n' % (i, bytes(t[i % 97 : i % 97 + 9]))
        for i in range(3000)
    ),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_emit_roundtrip(twain, name):
    rng = np.random.default_rng(11)
    data = CORPORA[name](twain, rng)
    body, lens = _device_encode(data)
    assert len(body) < len(data)
    blk = b"\x00" + put_uvarint(len(data)) + body
    assert odec.decode_block(blk) == data


def test_emit_incompressible_detectable():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 32 * 1024, np.uint8).tobytes()
    body, _ = _device_encode(data)
    # Caller must fall back to the uncompressed form.
    assert len(body) >= len(data)


def test_emit_matches_host_serializer(twain):
    """Byte-for-byte differential vs serialize_segment given the SAME
    verified token arrays (both mirror the reference decision tree)."""
    data = (twain * 4)[: 32 * 1024]
    flat, n = _pad(data)
    N = flat.shape[1]
    dist, length = ek.find_matches(flat, n, SEG)
    nrows = N // SEG
    take, tok_off, tok_len, _ = ek.greedy_parse(
        dist.reshape(nrows, SEG), length.reshape(nrows, SEG), SEG
    )
    surv, vlen = emit.verify_extend(
        flat.reshape(-1), take.reshape(-1), tok_off.reshape(-1), n, SEG
    )
    out, lens = emit.emit_segments(
        flat.reshape(-1), surv, tok_off.reshape(-1), vlen, n, SEG
    )
    out, lens = np.asarray(out), np.asarray(lens)
    surv_np = np.asarray(surv).reshape(nrows, SEG)
    off_np = np.asarray(tok_off).reshape(nrows, SEG)
    vlen_np = np.asarray(vlen).reshape(nrows, SEG)
    nseg = -(-n // SEG)
    for si in range(nseg):
        s0, s1 = si * SEG, min((si + 1) * SEG, n)
        # serialize_segment recomputes is_rep from its own chain when the
        # is_rep flag mirrors offset equality; feed the verified arrays.
        rep = -1
        is_rep = np.zeros(SEG, np.int32)
        for p in np.nonzero(surv_np[si])[0]:
            if off_np[si, p] == rep:
                is_rep[p] = 1
            rep = off_np[si, p]
        want = ek.serialize_segment(
            data[s0:s1], surv_np[si], off_np[si], vlen_np[si], is_rep
        )
        got = out[si, : lens[si]].tobytes()
        assert got == want, f"segment {si} differs"


def test_verify_extend_kills_bad_proposals(twain):
    """Hash-collision-style wrong proposals must be truncated/dropped, so
    device emission is correct by construction."""
    raw = bytearray((twain * 4)[: 16 * 1024])
    # Plant a true 12-byte repetition, then over-claim it with a proposal:
    # verification must truncate to the real length.
    raw[2000:2012] = raw[1000:1012]
    raw[2012] = raw[1012] ^ 0x5A  # force a mismatch at +12
    data = bytes(raw)
    flat, n = _pad(data)
    N = flat.shape[1]
    take = np.zeros(N, np.int32)
    off = np.zeros(N, np.int32)
    take[2000] = 1
    off[2000] = 1000
    surv, vlen = emit.verify_extend(
        flat.reshape(-1), jnp.asarray(take), jnp.asarray(off), n, SEG
    )
    surv, vlen = np.asarray(surv), np.asarray(vlen)
    assert surv[2000] == 1 and vlen[2000] == 12
    out, lens = emit.emit_segments(
        flat.reshape(-1), jnp.asarray(surv), jnp.asarray(off),
        jnp.asarray(vlen), n, SEG,
    )
    out, lens = np.asarray(out), np.asarray(lens)
    nseg = -(-n // SEG)
    # The single 12-byte copy cannot compress 16KiB below n; decode the
    # assembled body directly as an op stream instead.
    body = b"".join(out[i, : lens[i]].tobytes() for i in range(nseg))
    got = odec.decode_body(body, 0, n)
    assert got == data

    # And a proposal over entirely non-matching bytes must die.
    take2 = np.zeros(N, np.int32)
    off2 = np.zeros(N, np.int32)
    take2[3000] = 1
    off2[3000] = 777
    s2, v2 = emit.verify_extend(
        flat.reshape(-1), jnp.asarray(take2), jnp.asarray(off2), n, SEG
    )
    if data[3000:3004] != data[3000 - 777 : 3000 - 777 + 4]:
        assert np.asarray(s2)[3000] == 0


def test_sharded_encode_bit_exact(twain):
    """Mesh path: real bytes per block, deterministic stream offsets."""
    import jax
    from minlz_jax.parallel import (
        assemble_blocks,
        make_mesh,
        sharded_encode_blocks,
    )

    ndev = min(len(jax.devices()), 4)
    mesh = make_mesh(jax.devices()[:ndev])
    nb = ndev * 2
    N = WIN2
    mat = np.zeros((nb, N), np.int32)
    raw = []
    for b in range(nb):
        d = (twain[b * 511 :] + twain * 3)[:N]
        raw.append(d)
        mat[b] = np.frombuffer(d, np.uint8)
    valid = jnp.full((nb,), N, jnp.int32)
    seg_bytes, seg_lens, sizes, offs = sharded_encode_blocks(
        mesh, jnp.asarray(mat), valid, SEG
    )
    sizes, offs = np.asarray(sizes), np.asarray(offs)
    assert (np.diff(offs) == sizes[:-1]).all()
    blocks = assemble_blocks(seg_bytes, seg_lens, np.asarray(valid), SEG)
    for b, blk in enumerate(blocks):
        assert blk is not None
        assert odec.decode_block(blk) == raw[b]
