"""Concurrency stress for the multithreaded native parse+serialize.

The C++ ``minlz_parse_serialize`` threads across segment ranges internally
(and once shipped a vector<bool> data race); this module hammers it from
many Python threads (ctypes releases the GIL during the call) over many
repetitions and byte-compares every output against a single-threaded
baseline.  The reference's analog is its `-race -cpu=1/-cpu=4` CI matrix
(reference .github/workflows/go.yml:46-55).

A TSAN/ASAN build of the native library is provided by
scripts/sanitize_native.sh for deeper local checking.
"""

import concurrent.futures as cf

import numpy as np
import pytest

from minlz_jax.native.codec import get_codec
from minlz_jax.oracle import decode as odec
from minlz_jax.minlz import put_uvarint

SEG = 4096


@pytest.fixture(scope="module")
def corpus(twain):
    rng = np.random.default_rng(99)
    blocks = []
    for i in range(6):
        base = (twain[i * 997 :] + twain * 10)[: 128 * 1024]
        mutated = bytearray(base)
        for _ in range(64):
            mutated[int(rng.integers(0, len(mutated)))] = int(
                rng.integers(0, 256)
            )
        blocks.append(bytes(mutated))
    return blocks


def _dists(blocks):
    """Synthetic device-style match proposals: self-similarity distances
    (content is twain*k so dist=len(twain) hits often), plus noise."""
    out = []
    for b in blocks:
        n = len(b)
        d = np.zeros(n, np.int32)
        d[::7] = 14168  # twain period: many true matches, re-verified
        d[3::11] = 1024
        out.append(d)
    return out


def test_parse_serialize_thread_stress(corpus):
    codec = get_codec()
    if codec is None:
        pytest.skip("native codec unavailable")
    dists = _dists(corpus)
    baseline = [
        codec.parse_serialize(b, d, SEG) for b, d in zip(corpus, dists)
    ]
    for b, res in zip(corpus, baseline):
        body, hints = res
        blk = b"\x00" + put_uvarint(len(b)) + body
        assert odec.decode_block(blk) == b

    def worker(k):
        i = k % len(corpus)
        res = codec.parse_serialize(corpus[i], dists[i], SEG)
        return i, res

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        for i, res in ex.map(worker, range(96)):
            assert res == baseline[i], f"thread output diverged on block {i}"


def test_encode_block_thread_stress(corpus):
    codec = get_codec()
    if codec is None:
        pytest.skip("native codec unavailable")
    baseline = [codec.encode_block(b, 2) for b in corpus]

    def worker(k):
        i = k % len(corpus)
        return i, codec.encode_block(corpus[i], 2)

    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        for i, enc in ex.map(worker, range(48)):
            assert enc == baseline[i]
