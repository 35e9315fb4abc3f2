"""Per-block search table builder — vectorized.

The reference builds tables with unrolled per-matchLen byte loops and a SIMD
``packBits`` kernel (search_index.go:20-175, search_asm_*.s).  Here the whole
build is a handful of NumPy array passes (and the same math runs as jnp on
device): sliding-window values via shifts, the spec hash family vectorized,
presence bits via a scatter-OR — packBits becomes np.bitwise_or.at.

Boundary rules per SPEC_SEARCH.md §3.3.1/B.1: windows may extend into the
next block's first bytes (overlap); prefix-filtered positions still require
the prefix inside this block.
"""

from __future__ import annotations

import numpy as np

from .table import (
    TYPE_BYTE_PREFIX,
    TYPE_LONG_PREFIX,
    TYPE_MASK_PREFIX,
    TYPE_NO_PREFIX,
    SearchTableConfig,
    hash_values_np,
)


def _window_values(data: np.ndarray, match_len: int) -> np.ndarray:
    """uint64 little-endian values of every match_len-byte window.

    data: uint8 array of block bytes + overlap.  Returns values for
    positions 0 .. len(data)-match_len.
    """
    n = len(data) - match_len + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    vals = np.zeros(n, np.uint64)
    for k in range(match_len):
        vals |= data[k : k + n].astype(np.uint64) << np.uint64(8 * k)
    return vals


def build_table(
    block: bytes,
    cfg: SearchTableConfig,
    overlap: bytes = b"",
    block_size_hint: int = 0,
):
    """Build the bitmap for one block.

    Returns (table_bytes, reductions) or None when the table is denser than
    the configured population limit (the encoder then omits the chunk).
    """
    cfg.validate()
    bits = cfg.auto_bits(block_size_hint or len(block))
    m = cfg.match_len
    s = len(block)
    if s == 0:
        return None

    data = np.frombuffer(bytes(block) + bytes(overlap), np.uint8)

    if cfg.table_type == TYPE_NO_PREFIX:
        # Index windows starting at 0..S-1 (overlap supplies the tail;
        # window at S belongs to the next block).
        end = min(s, len(data) - m + 1)
        vals = _window_values(data, m)[:end]
    elif cfg.table_type in (TYPE_BYTE_PREFIX, TYPE_MASK_PREFIX):
        # Positions 1..S following a prefix byte inside this block.
        if cfg.table_type == TYPE_BYTE_PREFIX:
            pset = np.zeros(256, bool)
            pset[list(set(cfg.prefixes))] = True
        else:
            pset = np.zeros(256, bool)
            pset[list(cfg.prefix_mask)] = True
        vals_all = _window_values(data, m)
        hi = min(s + 1, len(vals_all))
        pos = np.nonzero(pset[data[: hi - 1]])[0] + 1
        vals = vals_all[pos]
    else:  # TYPE_LONG_PREFIX
        p = np.frombuffer(cfg.prefixes, np.uint8)
        pl = len(p)
        e = cfg.extra_matches
        vals_all = _window_values(data, m)
        # Prefix occurrences starting in this block (start <= S-1).
        if len(data) < pl:
            return _finish(np.zeros(0, np.uint64), cfg, bits)
        win = np.lib.stride_tricks.sliding_window_view(data, pl)
        starts = np.nonzero((win == p).all(axis=1))[0]
        starts = starts[starts < s]
        pos = []
        for k in range(e + 1):
            pk = starts + pl + k
            pk = pk[pk < len(vals_all)]
            pos.append(pk)
        pos = np.concatenate(pos) if pos else np.zeros(0, np.int64)
        vals = vals_all[pos]

    return _finish(vals, cfg, bits)


def _mulhi32(a, b):
    """High 32 bits of a 32x32 unsigned multiply on uint32 lanes (JAX runs
    without 64-bit integers by default, so the spec's 64-bit hash runs on
    16-bit limbs)."""
    import jax.numpy as jnp

    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> jnp.uint32(16)
    b0 = b & jnp.uint32(0xFFFF)
    b1 = b >> jnp.uint32(16)
    lo = a0 * b0
    mid1 = a1 * b0
    mid2 = a0 * b1
    carry = (
        (lo >> jnp.uint32(16))
        + (mid1 & jnp.uint32(0xFFFF))
        + (mid2 & jnp.uint32(0xFFFF))
    ) >> jnp.uint32(16)
    return a1 * b1 + (mid1 >> jnp.uint32(16)) + (mid2 >> jnp.uint32(16)) + carry


def build_tables_device(blocks_u8, match_len: int, bits: int):
    """Batched no-prefix table build on device (jnp): hash every window of
    every block and scatter presence bits — the reference's unrolled byte
    loops + SIMD packBits (search_index.go:33-66, search_asm_*.s) as three
    vector passes.  blocks_u8: [nblocks, block_size] uint8 (jnp or np).
    Returns [nblocks, 2^bits / 8] uint8 bitmaps (device array).

    All spec match lengths 1..8 are supported: the 64-bit multiply-shift
    family (SPEC_SEARCH.md §3.1, reference search_table.go:289-333) runs on
    32-bit lanes by computing only the product's high half —
    hash = high32(v * prime mod 2^64) >> (32 - bits) — so the on-wire
    bitmaps are bit-identical to the NumPy builder's.

    Window values use this block only (no overlap tail); callers append
    the next block's first match_len-1 bytes to the row to get
    spec-complete boundary indexing, as the stream writer does.
    """
    import jax
    import jax.numpy as jnp

    from .table import _PRIMES

    blocks = jnp.asarray(blocks_u8, jnp.uint32)
    nb, S = blocks.shape
    m = match_len
    npos = S - m + 1
    if m <= 4:
        vals = jnp.zeros((nb, S), jnp.uint32)
        for k in range(m):
            vals = vals | (jnp.roll(blocks, -k, axis=1) << jnp.uint32(8 * k))
        if m == 1:
            h = (vals & jnp.uint32(0xFF)).astype(jnp.int32)
        elif m == 2 and bits >= 16:
            h = (vals & jnp.uint32(0xFFFF)).astype(jnp.int32)
        else:
            shifted = (vals << jnp.uint32(8 * (4 - m))).astype(jnp.uint32)
            h = (
                (shifted * jnp.uint32(_PRIMES[m] & 0xFFFFFFFF))
                >> jnp.uint32(32 - bits)
            ).astype(jnp.int32)
    else:
        # Two 32-bit halves of the left-justified 64-bit window value:
        # byte k of the window sits at bit 8k + (64 - 8m).
        s = 64 - 8 * m
        x0 = jnp.zeros((nb, S), jnp.uint32)
        x1 = jnp.zeros((nb, S), jnp.uint32)
        for k in range(m):
            bk = jnp.roll(blocks, -k, axis=1)
            bit = 8 * k + s
            if bit < 32:
                x0 = x0 | (bk << jnp.uint32(bit))
            else:
                x1 = x1 | (bk << jnp.uint32(bit - 32))
        p = _PRIMES[m]
        p0 = jnp.uint32(p & 0xFFFFFFFF)
        p1 = jnp.uint32(p >> 32)
        # high32(x * p mod 2^64) for x = x0 + x1*2^32:
        hi = _mulhi32(x0, p0) + x0 * p1 + x1 * p0
        h = (hi >> jnp.uint32(32 - bits)).astype(jnp.int32)
    h = jnp.where(
        jnp.arange(S)[None, :] < npos, h, jnp.int32(1 << bits)
    )
    # Presence via one-hot count per bucket: segment-sum over positions.
    counts = jax.vmap(
        lambda hh: jnp.zeros((1 << bits) + 1, jnp.int32).at[hh].add(1)
    )(h)[:, : 1 << bits]
    bits_set = (counts > 0).astype(jnp.uint8)
    packed = bits_set.reshape(nb, (1 << bits) // 8, 8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))[None, None, :]
    return jnp.sum(packed * weights, axis=2, dtype=jnp.uint8)


def build_table_auto(
    block: bytes,
    cfg: SearchTableConfig,
    overlap: bytes = b"",
    block_size_hint: int = 0,
):
    """build_table with the device (jnp) builder on the default no-prefix
    path — this is what the stream writer calls, so the packBits-SIMD
    equivalent (reference search_index.go:20-66) runs on the device for the
    default config; prefix table types keep the NumPy path."""
    cfg.validate()
    if cfg.table_type != TYPE_NO_PREFIX or len(block) == 0:
        return build_table(block, cfg, overlap, block_size_hint)
    bits = cfg.auto_bits(block_size_hint or len(block))
    m = cfg.match_len
    # Windows must START inside this block (spec boundary rule); trimming
    # the row to block + (m-1) overlap bytes makes the device position mask
    # (npos = S - m + 1) coincide exactly with that rule.
    data = np.frombuffer(
        (bytes(block) + bytes(overlap))[: len(block) + m - 1], np.uint8
    )
    bitmap = np.asarray(
        build_tables_device(data[None, :], m, bits)
    )[0][: 1 << (bits - 3)]
    return _reduce_and_check(bitmap, cfg)


def _reduce_and_check(table: np.ndarray, cfg: SearchTableConfig):
    reductions = 0
    pop = np.unpackbits(table).sum()
    # Reduce while sparse enough and above the 256-entry floor.
    while (
        len(table) > 32
        and pop <= cfg.max_reduced_population * (len(table) * 4)
    ):
        half = len(table) // 2
        table = table[:half] | table[half:]
        reductions += 1
        pop = np.unpackbits(table).sum()

    if pop > cfg.max_population * (len(table) * 8):
        return None
    return table.tobytes(), reductions


def _finish(vals: np.ndarray, cfg: SearchTableConfig, bits: int):
    h = hash_values_np(vals, bits, cfg.match_len)
    nbytes = 1 << (bits - 3)
    table = np.zeros(nbytes, np.uint8)
    np.bitwise_or.at(table, h >> np.uint32(3),
                     (np.uint8(1) << (h & np.uint32(7))).astype(np.uint8))
    return _reduce_and_check(table, cfg)
