"""Device decode: transducer parse, then a plain-XLA executor.

One path serves both parse-hint versions (v1, and v2 with its range clamp):

  1. The host packs every segment's token stream of a batch of blocks into
     one ``[n_rows, lanes]`` byte matrix (column = segment).
  2. The transducer parse emits one op record per row and lane at most
     (``transducer.parse_step``): through the Triton kernel on a GPU
     (``parse_triton``), through ``lax.scan`` elsewhere.
  3. ``execute_records`` turns the records into bytes with gathers and
     scatters only.  Each record covers a literal span sourced from its
     lane's compressed bytes, then a copy span sourced from ``p - csrc``.
     Record starts are scattered and carried forward with a ``cummax``, so
     each output byte knows its record.  Every byte then holds a pointer
     into ``[compressed || output]``: a literal byte points into the
     compressed part and is a fixed point, a copy byte points back into
     the output.  Pointer doubling (``ptr = ptr[ptr]``) resolves every
     chain in at most ceil(log2(block bytes)) + 1 rounds, and one gather
     reads the bytes.

Copies may reach anywhere earlier in their block, so v1 hints (no range
clamp) decode here as well as v2.

Hostile input never reads out of bounds (XLA clamps gathers and drops
out-of-range scatters), and it never passes silently either: a record past
its segment, a literal past its stream, a copy that reads before its block
or at distance 0, or a byte that no record covers sets its block's flag,
and the caller raises ``CorruptError``.

Reference behaviour: minLZDecodeGo (decode.go:178).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..minlz import CorruptError
from .decode_kernel import parse_segments_scan
from .parse_triton import LANE_BLOCK, parse_segments_triton


def resolve_rounds(n: int) -> int:
    """Pointer-doubling rounds that resolve any chain inside n bytes."""
    return max(n - 1, 1).bit_length() + 1


def execute_records(src, start, llen, clen, csrc, lsrc, lo, rec_ok,
                    out_size: int, lit_stride: int = 1):
    """Record-level executor, plain ``jnp``/``lax``.

    src:    [C] uint8 literal source bytes.
    start:  [R] int32 output position of each record's first byte.
    llen, clen, csrc: [R] int32 literal length, copy length, copy distance.
    lsrc:   [R] int32 index in ``src`` of the record's first literal byte;
            literal byte k is ``src[lsrc + k * lit_stride]``.
    lo:     [R] int32 lowest output position the record's copy may read.
    rec_ok: [R] bool, the records to place (in any order).
    Returns (out [out_size] uint8, bad [out_size] bool, lost [R] bool,
    rounds): ``bad`` marks bytes that no record covers or whose copy reads
    before ``lo`` or at distance 0; ``lost`` marks placed records whose
    start another record also claimed; ``rounds`` counts the doubling
    rounds taken.  Positions with ``bad`` set hold arbitrary bytes.
    """
    C = src.shape[0]
    R = start.shape[0]
    p = jnp.arange(out_size, dtype=jnp.int32)
    ridx = jnp.arange(R, dtype=jnp.int32)
    at = jnp.where(rec_ok & (start >= 0), start, out_size)
    head = jnp.full((out_size,), -1, jnp.int32).at[at].set(ridx, mode="drop")
    lost = rec_ok & (head[jnp.clip(start, 0, out_size - 1)] != ridx)
    # Start of the record that covers each byte, carried forward.
    cover = jax.lax.cummax(jnp.where(head >= 0, p, -1))
    o = jnp.maximum(head[jnp.maximum(cover, 0)], 0)
    k = p - start[o]
    ll = llen[o]
    cs = csrc[o]
    is_lit = k < ll
    cpos = p - cs
    bad = (
        (cover < 0)
        | (k >= ll + clen[o])
        | (~is_lit & ((cs < 1) | (cpos < lo[o])))
    )
    ptr = jnp.where(is_lit, lsrc[o] + k * lit_stride, C + cpos)
    ptr = jnp.where(bad, 0, ptr)

    def unresolved(c):
        ptr, i = c
        return (i < resolve_rounds(out_size)) & jnp.any(ptr >= C)

    def jump(c):
        ptr, i = c
        nxt = ptr[jnp.clip(ptr - C, 0, out_size - 1)]
        return jnp.where(ptr >= C, nxt, ptr), i + 1

    ptr, rounds = jax.lax.while_loop(unresolved, jump, (ptr, jnp.int32(0)))
    bad = bad | (ptr >= C)
    return src[jnp.minimum(ptr, C - 1)], bad, lost, rounds


def parse_records(comp, lens, parse: str | None = None):
    """Transducer parse of comp [n_rows, lanes] uint8: "scan", "triton", or
    None for Triton on CUDA and ``lax.scan`` elsewhere."""
    if parse == "scan":
        return parse_segments_scan(comp.astype(jnp.int32), lens)
    if parse == "triton":
        return parse_segments_triton(comp, lens)
    return jax.lax.platform_dependent(
        comp, lens,
        cuda=lambda c, n: parse_segments_triton(c, n),
        default=lambda c, n: parse_segments_scan(c.astype(jnp.int32), n),
    )


def execute_parsed(emits, comp, lens, lane_base, lane_lo, lane_len,
                   lane_blk, blk_len, nblk: int, block_out: int):
    """Executor half of ``decode_batch_device``: parse emissions of
    ``comp`` [n_rows, lanes] -> (out [nblk, block_out] uint8, bad [nblk],
    doubling rounds)."""
    kind, dst, clen, csrc, lsrc, llen = emits[:6]
    lanes = comp.shape[1]
    lane = jnp.arange(lanes, dtype=jnp.int32)[None, :]
    L = lane_len[None, :]
    rec = kind > 0
    ok = (
        rec
        & (dst >= 0) & (llen >= 0) & (clen >= 0) & (lsrc >= 0)
        & (dst <= L) & (llen <= L) & (clen <= L)
        & (dst + llen + clen <= L)
        & (llen + clen >= 1)
        & (lsrc + llen <= lens[None, :])
    )
    start = lane_base[None, :] + dst
    out, bad, lost, rounds = execute_records(
        comp.reshape(-1),
        start.reshape(-1),
        llen.reshape(-1),
        clen.reshape(-1),
        csrc.reshape(-1),
        (lsrc * lanes + lane).reshape(-1),
        jnp.broadcast_to(lane_lo[None, :], kind.shape).reshape(-1),
        ok.reshape(-1),
        nblk * block_out,
        lit_stride=lanes,
    )
    rec_bad = jnp.any((rec & ~ok) | lost.reshape(kind.shape), axis=0)
    blk_bad = jnp.zeros((nblk,), jnp.int32).at[lane_blk].max(
        rec_bad.astype(jnp.int32)) > 0
    pos = jnp.arange(block_out, dtype=jnp.int32)[None, :]
    byte_bad = jnp.any(
        bad.reshape(nblk, block_out) & (pos < blk_len[:, None]), axis=1
    )
    return out.reshape(nblk, block_out), blk_bad | byte_bad, rounds


@functools.partial(jax.jit, static_argnames=("nblk", "block_out", "parse"))
def decode_batch_device(comp_lm, lens, lane_base, lane_lo, lane_len,
                        lane_blk, blk_len, nblk: int, block_out: int,
                        parse: str | None = None):
    """Fused batched decode: parse + execute in one dispatch.

    comp_lm:   [lanes, n_rows] uint8 token streams, lane-major as packed.
    lens:      [lanes] int32 stream lengths.
    lane_base: [lanes] int32 output position of each segment's first byte
               (block b occupies [b * block_out, b * block_out + blk_len[b])).
    lane_lo:   [lanes] int32 start of the segment's block.
    lane_len:  [lanes] int32 decoded segment length (0 for padding lanes).
    lane_blk:  [lanes] int32 block of each lane.
    blk_len:   [nblk] int32 decoded block lengths.
    parse:     "scan", "triton", or None (Triton on CUDA, scan elsewhere).
    Returns (out [nblk, block_out] uint8, bad [nblk] bool).
    """
    comp = comp_lm.T  # [n_rows, lanes]
    out, bad, _ = execute_parsed(
        parse_records(comp, lens, parse), comp, lens, lane_base, lane_lo,
        lane_len, lane_blk, blk_len, nblk, block_out,
    )
    return out, bad


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def row_bucket(n: int) -> int:
    """Rows for streams up to n - 1 bytes: the next of 2^k or 3 * 2^(k-1),
    at least 256, so few shapes compile and padding stays under a third."""
    b = 256
    while b < n:
        b = b * 3 // 2 if b & (b - 1) == 0 else b // 3 * 4
    return b


def plan_batch(blocks_segs, out_lens, seg: int):
    """Host-side packing for ``decode_batch_device``.

    blocks_segs: per block, the list of segment token streams (bytes);
    out_lens: decoded block lengths.  Raises CorruptError when the hints do
    not fit the block (segment count, stream length).  Returns
    (arrays, statics) for ``decode_batch_device``.
    """
    nseg_total = 0
    longest = 0
    for segs, n in zip(blocks_segs, out_lens):
        if len(segs) != -(-n // seg):
            raise CorruptError(
                f"{len(segs)} hint segments for {n} bytes at {seg} per segment"
            )
        nseg_total += len(segs)
        longest = max([longest, *(len(s) for s in segs)])
    # A valid segment stream is at most its literals plus their headers;
    # anything far longer is corrupt hints, not a block to pad lanes for.
    if longest > 2 * seg + 1024:
        raise CorruptError(f"segment stream of {longest} bytes exceeds bound")
    lanes = max(_pow2(nseg_total), LANE_BLOCK)
    n_rows = row_bucket(longest + 1)
    nblk = _pow2(len(blocks_segs))
    block_out = max(_pow2(max(out_lens)), seg)

    comp = np.zeros((lanes, n_rows), np.uint8)
    lens = np.zeros(lanes, np.int32)
    lane_base = np.zeros(lanes, np.int32)
    lane_lo = np.zeros(lanes, np.int32)
    lane_len = np.zeros(lanes, np.int32)
    lane_blk = np.zeros(lanes, np.int32)
    blk_len = np.zeros(nblk, np.int32)
    li = 0
    for b, (segs, n) in enumerate(zip(blocks_segs, out_lens)):
        blk_len[b] = n
        for i, s in enumerate(segs):
            comp[li, : len(s)] = np.frombuffer(s, np.uint8)
            lens[li] = len(s)
            lane_base[li] = b * block_out + i * seg
            lane_lo[li] = b * block_out
            lane_len[li] = min(seg, n - i * seg)
            lane_blk[li] = b
            li += 1
    arrays = (comp, lens, lane_base, lane_lo, lane_len, lane_blk, blk_len)
    return arrays, dict(nblk=nblk, block_out=block_out)


def decode_blocks(blocks_segs, out_lens, seg: int):
    """Decode a batch of hinted blocks in one dispatch.  Returns a list with
    the decoded bytes of each block, or None for a block the device found
    corrupt.  Raises CorruptError when the hints do not fit the blocks."""
    arrays, statics = plan_batch(blocks_segs, out_lens, seg)
    out, bad = decode_batch_device(*(jnp.asarray(a) for a in arrays),
                                   **statics)
    out = np.asarray(out)
    bad = np.asarray(bad)
    return [
        None if bad[b] else out[b, :n].tobytes()
        for b, n in enumerate(out_lens)
    ]
