"""Differential hardening of the native (C++) block decoder.

The reference replays its regression corpora against the optimized decoder
(decode_asm_test.go:28-49, writer_test.go:83) because the fast path works on
raw pointers — exactly where a bounds bug is memory-unsafe.  Our C++
``minlz_decode_block`` gets the same treatment: every corpus input must
either decode identically to the pure-Python oracle or raise CorruptError in
BOTH implementations.  No third outcome (crash, divergent bytes, one-sided
error) is acceptable.
"""

import pytest
from conftest import load_corpus

from minlz_jax import minlz
from minlz_jax.native.codec import get_codec
from minlz_jax.oracle import decode as odec
from minlz_jax.oracle import encode as oenc

codec = get_codec()
pytestmark = pytest.mark.skipif(codec is None, reason="native lib unavailable")


def _oracle_result(data):
    try:
        return odec.decode_block(data), None
    except minlz.CorruptError as e:
        return None, e


def _native_result(data):
    try:
        return codec.decode_block(data), None
    except minlz.CorruptError as e:
        return None, e


def _differential(corpus_name, inputs):
    for i, data in enumerate(inputs):
        if len(data) > minlz.MAX_BLOCK_SIZE * 2:
            continue
        want, oerr = _oracle_result(data)
        got, nerr = _native_result(data)
        if oerr is not None:
            assert nerr is not None, (
                f"{corpus_name}[{i}]: oracle rejected ({oerr}) but native "
                f"decoded {len(got)} bytes"
            )
        else:
            assert nerr is None, (
                f"{corpus_name}[{i}]: oracle decoded {len(want)} bytes but "
                f"native rejected ({nerr})"
            )
            assert got == want, f"{corpus_name}[{i}]: output mismatch"


def test_native_dec_block_regressions():
    _differential(
        "dec-block-regressions", load_corpus("dec-block-regressions.zip")
    )


def test_native_block_corpus_dec():
    _differential("block-corpus-dec", load_corpus("block-corpus-dec.zip"))


def test_native_enc_regressions_roundtrip():
    """Encoder regression seeds: every input must roundtrip through every
    native level and decode identically via native and oracle decoders
    (reference writer_test.go:83)."""
    for i, data in enumerate(load_corpus("enc_regressions.zip")):
        if len(data) > minlz.MAX_BLOCK_SIZE:
            continue
        for level in (0, 1, 2, 3):
            enc = codec.encode_block(data, level)
            assert len(enc) <= minlz.max_encoded_len(len(data)), (i, level)
            assert codec.decode_block(enc) == data, (i, level)
            assert odec.decode_block(enc) == data, (i, level)


def test_native_rejects_mutated_golden(twain_mzb):
    """Byte-flip fuzz over the golden block: native must never crash and must
    agree with the oracle on accept/reject + output."""
    import random

    rng = random.Random(0xC0DEC)
    base = bytearray(twain_mzb)
    cases = []
    for _ in range(200):
        b = bytearray(base)
        for _ in range(rng.randint(1, 4)):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        cases.append(bytes(b))
    # Truncations hit the tail bounds checks.
    for cut in (1, 2, 3, 7, 100, len(base) // 2):
        cases.append(bytes(base[:-cut]))
    _differential("mutated-golden", cases)


def test_native_oracle_encode_cross_decode():
    """Oracle-encoded corpus blocks decode identically on the native path."""
    for i, data in enumerate(load_corpus("block-corpus-enc.zip", limit=200)):
        if not data or len(data) > minlz.MAX_BLOCK_SIZE:
            continue
        enc = oenc.encode_block(data)
        assert codec.decode_block(enc) == data, i
