"""Differential tests: transducer parse+execute vs the Python oracle.

The whole block body is treated as a single segment (hints produce multiple
segments, exercised in stream-level tests).
"""

import numpy as np
import pytest

from minlz_jax import minlz
from minlz_jax.oracle import decode as odec
from minlz_jax.oracle import encode as oenc
from minlz_jax.ops.decode_kernel import decode_segments_jnp

from conftest import load_corpus


def _decode_via_transducer(block: bytes) -> bytes:
    lit_only, want, pos = odec.parse_header(block)
    if lit_only:
        return bytes(block[pos:])
    if want == 0:
        return b""
    body = block[pos:]
    outs = decode_segments_jnp([body], [want])
    return outs[0]


def test_golden_block(twain, twain_mzb):
    assert _decode_via_transducer(twain_mzb) == twain


def test_own_encoder_output(twain):
    enc = oenc.encode_block(twain)
    assert _decode_via_transducer(enc) == twain


def test_handbuilt_op_coverage():
    """One block exercising every op family and extension width."""
    dst = bytearray()
    prefix = bytes(range(256)) * 300  # 76800 bytes, gives copy2 range
    oenc.emit_literals(dst, prefix)
    oenc.emit_repeat(dst, 300)        # repeat of offset... initial? no: after
    # literals, repeat offset is still initial 1 -> RLE of last byte
    oenc.emit_copy1(dst, 17, 12)
    oenc.emit_copy1(dst, 1000, 270)   # ext length
    oenc.emit_copy2(dst, 2000, 4)
    oenc.emit_copy2(dst, 65599, 100)  # ext length
    oenc.emit_repeat(dst, 5)
    oenc.emit_fused2(dst, b"AB", 300, 7)
    oenc.emit_fused2(dst, b"WXYZ", 70, 50)  # long fused -> repeat chain
    oenc.emit_copy3(dst, 70000, 40, b"xyz")
    oenc.emit_copy3(dst, 76000, 80)   # ext length, no lits
    oenc.emit_literals(dst, b"Q" * 40000)  # 2-byte ext literals
    oenc.emit_repeat(dst, 70000)      # huge repeat (offset = last copy's 76000)

    # Reconstruct the expected output with plain python, then cross-check
    # the oracle decoder against it before testing the transducer.
    out = bytearray(prefix)
    out += out[-1:] * 300
    def cp(off, ln):
        s = len(out) - off
        for i in range(ln):
            out.append(out[s + i])
    cp(17, 12); cp(1000, 270); cp(2000, 4); cp(65599, 100); cp(65599, 5)
    out += b"AB"; cp(300, 7)
    out += b"WXYZ"; cp(70, 50)
    out += b"xyz"; cp(70000, 40)
    cp(76000, 80)
    out += b"Q" * 40000
    cp(76000, 70000)  # repeat reuses the last copy's offset

    block = b"\x00" + minlz.put_uvarint(len(out)) + bytes(dst)
    want = odec.decode_block(block)
    assert want == bytes(out)  # oracle agrees with hand-computation
    assert _decode_via_transducer(block) == want


def test_corpus_differential():
    """Transducer must agree with the oracle on every decodable corpus
    block (corrupt blocks are decoded by neither or rejected host-side)."""
    n_checked = 0
    for data in load_corpus("block-corpus-dec.zip"):
        try:
            want = odec.decode_block(data)
        except minlz.CorruptError:
            continue
        got = _decode_via_transducer(bytes(data))
        assert got == want
        n_checked += 1
        if n_checked >= 25:
            break
    # The decode fuzz corpus is mostly malformed seeds; only a handful decode.
    assert n_checked >= 2

    # Widen coverage with valid blocks produced from the encode corpus.
    n_enc = 0
    for data in load_corpus("block-corpus-enc.zip"):
        if not 64 <= len(data) <= 65536:
            continue
        block = oenc.encode_block(data)
        lit_only, want, pos = odec.parse_header(block)
        if lit_only or want == 0:
            continue
        assert _decode_via_transducer(block) == data
        n_enc += 1
        if n_enc >= 20:
            break
    assert n_enc >= 10


def test_multi_segment_batch(twain):
    """Many segments decoded in one lockstep batch."""
    blocks = []
    wants = []
    rng = np.random.default_rng(42)
    for i in range(17):
        n = int(rng.integers(100, 3000))
        start = int(rng.integers(0, len(twain) - n))
        data = twain[start : start + n]
        enc = oenc.encode_block(data)
        lit_only, want, pos = odec.parse_header(enc)
        if lit_only or want == 0:
            continue
        blocks.append(enc[pos:])
        wants.append(data)
    outs = decode_segments_jnp(blocks, [len(w) for w in wants])
    for got, want in zip(outs, wants):
        assert got == want
