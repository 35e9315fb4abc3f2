"""Batched segment encode: sort-based match finding + lockstep greedy parse.

Data-parallel redesign of the reference's hash-table LZ77 (encode_l1.go:39):

  * Candidate finding: instead of a sequential single-slot hash table,
    batched (hash|pos)-key sorts over 16KiB windows (two passes, aligned and
    half-shifted).  The sorted predecessor with equal hash and equal 4-byte
    value IS what a perfect collision-free table would have returned — the
    most recent previous occurrence — computed for every position at once.
    Long-range (>8KiB) candidates are a roadmap item (sampled global pass).
  * Match extension: byte-exact lengths from runs of consecutive
    same-distance candidates, counted by log-doubling over static shifts
    (no gathers anywhere).
  * Greedy parse: a position-lockstep scan per segment (state = skip
    counter, repeat offset) picks tokens like the reference's greedy loop
    but vectorized across segments.
  * Serialization emits per-segment token streams that concatenate into one
    legal MinLZ block body; parse hints (chunk 0x88) record each segment's
    (comp_off, out_off).

Matches may REFERENCE any earlier position in the block (full window, same
as the reference), but never extend past their own segment's end — segments
stay independently parseable, and the decode executor resolves
cross-segment references anywhere earlier in the block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..minlz import put_uvarint
from ..oracle import encode as oenc

# Segment size (positions per lane); must match the decode hint segmentation.
SEG = 4096
# Match-finder window: candidates are found within aligned windows of this
# size (batched sort rows).  Offsets therefore stay < WINDOW; length
# extension still runs globally and matches are capped only at SEG
# boundaries.  WINDOW <= 16384 keeps (hash17 | pos14) inside int32.
WINDOW = 16384
# Match-source clamp of parse-hints v2: with rng = RANGE every match source
# lies in the RANGE-aligned range of its destination (``find_matches_dyn``
# mask + the native parse's backward-extension clamp).  128 KiB costs ~0.2
# ratio points less than 64 KiB.  The device decoder no longer needs the
# clamp (ops/executor.py resolves any in-block source); the stream format
# keeps it until a ratio change drops it.
RANGE = 128 * 1024
_HASH_BITS = 17
_POS_BITS = 14
_PRIME4 = np.uint32(2654435761)


_MAX_OFFSET = (1 << 21) + 65535


def _window_pass(keyflat, vals, M, W, shift, nback, pos_bits=_POS_BITS):
    """One batched windowed-sort candidate pass over M samples.

    keyflat: [1, M] int32 = hash << pos_bits (invalid samples pre-marked
    with a sentinel above every valid key); vals: co-verified value arrays
    ([1, M] int32 each) — a candidate requires equal hash AND equal values.
    Returns nback candidate arrays ([1, M] global sample index or -1): the
    1st..nback-th previous same-key sample within the window.
    """
    k = jnp.roll(keyflat, shift, axis=1) if shift else keyflat
    vs = [jnp.roll(v, shift, axis=1) if shift else v for v in vals]
    nwin = M // W
    lpos = jnp.broadcast_to(jnp.arange(W, dtype=jnp.int32)[None, :], (nwin, W))
    key = k.reshape(nwin, W) | lpos
    sorted_ = jax.lax.sort(
        (key, *[v.reshape(nwin, W) for v in vs]), dimension=1, num_keys=1
    )
    key_s = sorted_[0]
    vs_s = sorted_[1:]
    pos_s = key_s & ((1 << pos_bits) - 1)
    h_s = key_s >> pos_bits
    idx = jnp.arange(W)[None, :]
    cs = []
    for back in range(1, nback + 1):
        ok = (h_s == jnp.roll(h_s, back, axis=1)) & (idx >= back)
        for v in vs_s:
            ok &= v == jnp.roll(v, back, axis=1)
        cs.append(jnp.where(ok, jnp.roll(pos_s, back, axis=1), -1))
    unsorted = jax.lax.sort((pos_s, *cs), dimension=1, num_keys=1)
    base = (jnp.arange(nwin, dtype=jnp.int32) * W)[:, None]
    out = []
    for c in unsorted[1:]:
        g = jnp.where(c >= 0, c + base, -1).reshape(1, M)
        if shift:
            # Undo the roll: array index -> original sample index.
            g = jnp.roll(g, -shift, axis=1)
            g = jnp.where(g >= 0, (g - shift) % M, -1)
        out.append(g)
    return out


def _run_doubling(ext, cap):
    """runs[i] = length of the consecutive-True run starting at i+? — counts
    extensions by log-doubling; capped at `cap` (segment room bounds all
    useful lengths, so deeper doubling is wasted work)."""
    runs = ext.astype(jnp.int32)
    shift = 1
    while shift < cap:
        carry = jnp.roll(runs, -shift, axis=1)
        runs = runs + jnp.where(runs == shift, carry, 0)
        shift *= 2
    return runs


def find_matches_dyn(data_flat, n, seg: int = SEG, rng: int = 0,
                     level: int = 2, exact: bool = False):
    """data_flat: [1, N] int32 bytes of the whole block (N = padded);
    ``n`` may be a traced scalar (shard_map / vmap use).

    rng (power of two, 0 = off): clamp match sources to the rng-aligned
    range of their destination (hints v2, see ``RANGE``).  Matches already
    never cross segment ends, so the clamp is a single check per match.

    ``level`` scales effort (the reference's encodeBlock level dispatch,
    encode_l0.go:32 / encode_l1.go:39 / encode_l2.go:61 / encode_l3.go:38,
    mapped to sort-pass count and candidate depth):
      * -1 — one aligned short-range pass, single candidate: fastest.
      *  1 — both short-range passes + the stride-8 mid-range tier.
      *  2 — adds the stride-64 long-range tier (the prior default).
      *  3 — deeper candidate sets (nback+1) in every tier.

    Tier structure (all tiers are batched windowed sorts — no hash tables,
    no gathers):
      * short — stride 1, 4-byte values, byte-exact runs; covers
        distances < ~32KiB.
      * mid — stride 8, 8-byte sample values (fully verified via two
        co-sorted words; consecutive samples tile contiguously), lengths in
        8-byte units; covers distances < ~128KiB.
      * long — stride 64, two 32-bit mixes of each 64-byte chunk
        (hash-verified only — the host serializer re-verifies every match
        byte-exactly); covers distances < ~1MiB.
    Returns (dist, length) as [1, N] int32.  Lengths from mid/long tiers
    are proposals measured in whole strides; the host parse re-extends.
    Length is capped so no match output crosses a segment boundary (the
    decode-parallel unit).
    """
    N = data_flat.shape[1]
    d = data_flat.astype(jnp.uint32)
    pos = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None, :], (1, N))

    best_dist = jnp.zeros_like(pos)
    best_len = jnp.zeros_like(pos)
    deep = 1 if level >= 3 else 0

    # ---- short tier: stride 1, exact 4-byte windows ----------------------
    v0 = (
        d
        | jnp.roll(d, -1, axis=1) << 8
        | jnp.roll(d, -2, axis=1) << 16
        | jnp.roll(d, -3, axis=1) << 24
    )
    # The short tier uses 32KiB windows (hash16 | pos15 packs into int32)
    # for 2x the exact-match reach of the strided tiers' 16KiB windows.
    W = 2 * WINDOW if N % (2 * WINDOW) == 0 else min(WINDOW, N)
    pos_bits0 = W.bit_length() - 1 if W < 32768 else 15
    h = ((v0 * _PRIME4) >> (32 - 16)).astype(jnp.int32)
    valid = pos <= n - 4
    sentinel0 = (1 << 31) - (1 << pos_bits0)
    keyflat = jnp.where(valid, (h << pos_bits0), sentinel0)
    v0i = v0.astype(jnp.int32)

    # Two passes (aligned + half-window shifted): short matches crossing
    # window boundaries are invisible to the aligned pass AND to the
    # strided tiers (8-byte sampling rarely aligns on a <16-byte match),
    # so the shifted pass is worth its sort cost — dropping it costs ~8
    # ratio points on match-dense data (measured on the bench corpus).  Level -1
    # drops it anyway: speed over ratio is that level's contract.
    # exact=False (default) drops the co-sorted value payload — candidates
    # match on hash16 alone, cutting short-tier sort bandwidth ~40%.
    # The host serializer
    # re-verifies every proposal byte-exactly, so correctness is
    # unaffected and the only risk is hash-collision proposals displacing
    # real candidates: a clean same-corpus A/B measured ratio 0.6679 vs
    # 0.6677 — neutral; the per-level Twain watermark tests gate drift.
    v0s = [v0i] if exact else []
    cands = _window_pass(keyflat, v0s, N, W, 0,
                         nback=(1 if level < 1 else 2 + deep),
                         pos_bits=pos_bits0)
    if N > W and level >= 1:
        cands += _window_pass(keyflat, v0s, N, W, W // 2, nback=1 + deep,
                              pos_bits=pos_bits0)

    for cand in cands:
        dist = jnp.where(cand >= 0, pos - cand, 0)
        dist = jnp.where((dist > 0) & (dist <= _MAX_OFFSET), dist, 0)
        if rng:
            dist = jnp.where(dist <= (pos & (rng - 1)), dist, 0)
        dist1 = jnp.roll(dist, -1, axis=1)
        ext = (dist > 0) & (dist1 == dist) & (pos + 5 <= n)
        # Lengths are merge hints only (the host re-extends byte-exactly),
        # so capping the doubling depth at 256 costs nothing downstream.
        runs = _run_doubling(ext, min(seg, 256))
        length = jnp.where(dist > 0, 4 + runs, 0)
        better = length > best_len
        best_dist = jnp.where(better, dist, best_dist)
        best_len = jnp.where(better, length, best_len)

    # ---- mid/long tiers: strided samples for long-range matches ----------
    # A tier only adds candidates at distances up to stride * window; when
    # the range clamp is tighter than the PREVIOUS tier's reach already
    # covers, the longer tier cannot contribute a single surviving match —
    # skip its sorts outright (e.g. the stride-64 tier is pure waste under
    # a 128 KiB clamp, which the stride-8 tier fully covers).
    tiers = []
    if level >= 1:
        tiers.append((8, False))
    if level >= 2 and not (rng and rng <= 8 * WINDOW):
        tiers.append((64, True))
    for stride, mixed in tiers:
        M = N // stride
        if M < 256:
            break
        words = data_flat.reshape(1, M, stride).astype(jnp.uint32)
        w32 = [
            (
                words[:, :, k]
                | words[:, :, k + 1] << 8
                | words[:, :, k + 2] << 16
                | words[:, :, k + 3] << 24
            )
            for k in range(0, stride, 4)
        ]
        if mixed:
            # Two independent 32-bit multiplicative mixes of the chunk.
            m1 = jnp.zeros_like(w32[0])
            m2 = jnp.zeros_like(w32[0])
            for w in w32:
                m1 = m1 * np.uint32(2654435761) + w
                m2 = m2 * np.uint32(0x9E3779B1) + (w ^ np.uint32(0x85EBCA6B))
            vals = [m1.astype(jnp.int32), m2.astype(jnp.int32)]
            hs = ((m1 ^ m2) * _PRIME4) >> (32 - _HASH_BITS)
        else:
            vals = [w.astype(jnp.int32) for w in w32]
            hs = ((w32[0] * _PRIME4) ^ (w32[1] * np.uint32(0x9E3779B1))) >> (
                32 - _HASH_BITS
            )
        hs = hs.astype(jnp.int32)
        spos = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[None, :], (1, M))
        svalid = spos * stride + stride <= n
        sentinel = (1 << 31) - (1 << _POS_BITS)
        keyflat = jnp.where(svalid, hs << _POS_BITS, sentinel)
        Ws = min(WINDOW, M)
        while M % Ws:  # sort rows must tile M exactly
            Ws //= 2
        scands = _window_pass(keyflat, vals, M, Ws, 0, nback=1 + deep)
        # The shifted pass exists for matches straddling a sort-window
        # boundary.  When the range clamp tiles the sample windows exactly
        # (stride * Ws a multiple of rng, e.g. stride-8 x 16Ki samples =
        # 128 KiB windows under the 128 KiB clamp), every cross-window
        # candidate is illegal anyway — the pass is pure sort cost, skip
        # it.
        cross_useful = not (rng and (stride * Ws) % rng == 0)
        if M > Ws and cross_useful:
            scands += _window_pass(keyflat, vals, M, Ws, Ws // 2,
                                   nback=1 + deep)
        run_cap = max(seg // stride, 2)
        sd_best = jnp.zeros_like(spos)
        sl_best = jnp.zeros_like(spos)
        for cand in scands:
            sd = jnp.where(cand >= 0, spos - cand, 0)
            sdist = sd * stride
            sdist = jnp.where((sd > 0) & (sdist <= _MAX_OFFSET), sdist, 0)
            if rng:
                sdist = jnp.where(
                    sdist <= ((spos * stride) & (rng - 1)), sdist, 0
                )
            sd1 = jnp.roll(sdist, -1, axis=1)
            ext = (sdist > 0) & (sd1 == sdist)
            runs = _run_doubling(ext, run_cap)
            ln = jnp.where(sdist > 0, stride * (1 + runs), 0)
            better = ln > sl_best
            sd_best = jnp.where(better, sdist, sd_best)
            sl_best = jnp.where(better, ln, sl_best)
        # Expand sample hits to full resolution (value at sample position).
        zeros = jnp.zeros((1, M, stride - 1), jnp.int32)
        dist_full = jnp.concatenate(
            [sd_best[:, :, None], zeros], axis=2
        ).reshape(1, N)
        len_full = jnp.concatenate(
            [sl_best[:, :, None], zeros], axis=2
        ).reshape(1, N)
        better = len_full > best_len
        best_dist = jnp.where(better, dist_full, best_dist)
        best_len = jnp.where(better, len_full, best_len)

    # No match may cross its segment end (decode-parallel boundary) nor the
    # block end.
    seg_room = seg - (pos % seg)
    best_len = jnp.minimum(best_len, jnp.minimum(seg_room, n - pos))
    best_len = jnp.where(best_len >= 4, best_len, 0)
    best_dist = jnp.where(best_len >= 4, best_dist, 0)
    return best_dist, best_len


@functools.partial(jax.jit, static_argnames=("n", "seg", "rng", "level"))
def find_matches(data_flat, n: int, seg: int = SEG, rng: int = 0,
                 level: int = 2):
    """jit-cached wrapper of find_matches_dyn for static block sizes."""
    return find_matches_dyn(data_flat, n, seg, rng, level)


@functools.partial(jax.jit, static_argnames=("seg", "max_ops"))
def greedy_parse_compact(off, length, seg: int = SEG, max_ops: int = 0):
    """Greedy parse (``greedy_parse``) + on-device compaction to a dense op
    list.

    off, length: [nrows, seg] int32 (row = segment span, ascending).
    Returns (pos, off, len, is_rep) arrays of shape [max_ops] (global
    positions, ascending; padded tail has len 0) plus the real count.
    Minimizes device->host traffic for the serializer.
    """
    nrows = off.shape[0]
    if max_ops == 0:
        max_ops = nrows * seg // 4
    take, _, _, is_rep = greedy_parse(off, length, seg)

    flat_take = take.reshape(-1)
    sel = jnp.nonzero(flat_take > 0, size=max_ops, fill_value=0)[0]
    valid = (flat_take > 0)[sel]
    z = jnp.where(valid, 1, 0)
    return (
        sel.astype(jnp.int32),
        off.reshape(-1)[sel] * z,
        length.reshape(-1)[sel] * z,
        is_rep.reshape(-1)[sel] * z,
        jnp.sum(flat_take),
    )


@functools.partial(jax.jit, static_argnames=("seg",))
def greedy_parse(off, length, seg: int = SEG):
    """Lockstep greedy token selection over [B, seg] per-segment lanes.

    Returns per-position arrays: take (a copy token starts), tok_off,
    tok_len, is_rep (offset equals the lane's previous copy offset).
    """
    B = off.shape[0]

    def step(carry, inp):
        skip, rep = carry
        o, l = inp
        take = (skip == 0) & (l >= 4)
        tok_off = jnp.where(take, o, 0)
        tok_len = jnp.where(take, l, 0)
        is_rep = take & (o == rep)
        new_skip = jnp.where(take, l - 1, jnp.maximum(skip - 1, 0))
        new_rep = jnp.where(take, o, rep)
        return (new_skip, new_rep), (
            take.astype(jnp.int32),
            tok_off,
            tok_len,
            is_rep.astype(jnp.int32),
        )

    skip0 = jnp.zeros((B,), jnp.int32)
    rep0 = jnp.full((B,), -1, jnp.int32)
    (_, _), outs = jax.lax.scan(step, (skip0, rep0), (off.T, length.T))
    take, tok_off, tok_len, is_rep = (o.T for o in outs)
    return take, tok_off, tok_len, is_rep


def serialize_block(data: bytes, pos, off, ln, is_rep, count,
                    seg: int = SEG):
    """Serialize a whole block from a compacted global op list.

    Returns (body_bytes, hints) with hints = [(comp_off, out_off), ...] per
    segment.  Ops must be ascending by position and never cross segment
    boundaries (guaranteed by find_matches' length cap).
    """
    n = len(data)
    nseg = -(-n // seg)
    body = bytearray()
    hints = []
    i = 0
    count = int(count)
    for si in range(nseg):
        s0 = si * seg
        s1 = min(s0 + seg, n)
        hints.append((len(body), s0))
        lit_start = s0
        rep = -1
        while i < count and pos[i] < s1:
            p = int(pos[i])
            o = int(off[i])
            l = int(ln[i])
            # Device lengths are proposals (coarse levels are hash-verified
            # only): confirm byte-exactly, truncating at first mismatch.
            lv = 0
            while lv < l and data[p + lv] == data[p - o + lv]:
                lv += 1
            l = lv
            if l < 4:
                i += 1
                continue
            lits = data[lit_start:p]
            if is_rep[i] and o == rep:
                if lits:
                    oenc.emit_literals(body, lits)
                oenc.emit_repeat(body, l)
            else:
                can_fuse = (
                    lits
                    and o >= 64
                    and o != rep
                    and (len(lits) <= 3 or (o <= 65599 and len(lits) <= 4))
                )
                if can_fuse:
                    if o <= 65599:
                        oenc.emit_fused2(body, lits, o, l)
                    else:
                        oenc.emit_copy3(body, o, l, lits)
                else:
                    if lits:
                        oenc.emit_literals(body, lits)
                    if o == rep:
                        oenc.emit_repeat(body, l)
                    elif o <= 1024:
                        oenc.emit_copy1(body, o, l)
                    elif o <= 65599:
                        oenc.emit_copy2(body, o, l)
                    else:
                        oenc.emit_copy3(body, o, l)
                rep = o
            lit_start = p + l
            i += 1
        if lit_start < s1:
            oenc.emit_literals(body, data[lit_start:s1])
    return bytes(body), hints


def serialize_segment(src: bytes, take, tok_off, tok_len, is_rep) -> bytes:
    """Emit the MinLZ token stream for one segment from parse arrays.

    Token choice mirrors the reference greedy encoder's decision tree
    (internal/reference/encoder.go:174-221): fused literals when possible,
    repeat when the offset matches, otherwise the smallest copy op.
    """
    dst = bytearray()
    n = len(src)
    rows = np.nonzero(take[: n])[0]
    lit_start = 0
    rep = -1
    for p in rows:
        p = int(p)
        off = int(tok_off[p])
        ln = int(tok_len[p])
        lits = src[lit_start:p]
        if is_rep[p]:
            if lits:
                oenc.emit_literals(dst, lits)
            oenc.emit_repeat(dst, ln)
        else:
            can_fuse = (
                lits
                and off >= 64
                and off != rep
                and (len(lits) <= 3 or (off <= 65599 and len(lits) <= 4))
            )
            if can_fuse:
                if off <= 65599:
                    oenc.emit_fused2(dst, lits, off, ln)
                else:
                    oenc.emit_copy3(dst, off, ln, lits)
            else:
                if lits:
                    oenc.emit_literals(dst, lits)
                if off == rep:
                    oenc.emit_repeat(dst, ln)
                elif off <= 1024:
                    oenc.emit_copy1(dst, off, ln)
                elif off <= 65599:
                    oenc.emit_copy2(dst, off, ln)
                else:
                    oenc.emit_copy3(dst, off, ln)
            rep = off
        lit_start = p + ln
    if lit_start < n:
        oenc.emit_literals(dst, src[lit_start:])
    return bytes(dst)


@functools.partial(jax.jit, static_argnames=("seg", "rng", "level"))
def _find_matches_batch(data_u8, ns, seg: int = SEG, rng: int = 0,
                        level: int = 2):
    """vmapped match finding over [B, N] blocks with per-block valid
    lengths — one device dispatch for a whole batch of stream blocks."""

    def one(d, n):
        dist, _ = find_matches_dyn(d[None, :].astype(jnp.int32), n, seg,
                                   rng, level)
        return dist[0]

    return jax.vmap(one)(data_u8, ns)


def _size_class(total: int) -> int:
    """Sort-geometry size class: the smallest power-of-two row that holds
    the block, up to the full 2*WINDOW level-0 row (then multiples of it).
    The reference generates per-size-class encoder variants
    (reference asm_amd64.go:12-152, _generate/gen.go:59-89); here
    the class picks how many rows the batched sorts process — a 16 KiB
    block sorts 4x less than the 64 KiB worst case."""
    if total >= 2 * WINDOW:
        return -(-total // (2 * WINDOW)) * (2 * WINDOW)
    return 1 << max((total - 1).bit_length(), 12)


def encode_blocks_device(blocks, seg: int = SEG, rng: int = 0,
                         level: int = 2):
    """Encode a batch of blocks with ONE device dispatch (the stream
    writer's batching path; replaces per-block dispatches).

    rng > 0 clamps match sources to rng-aligned ranges (both in the device
    finder and the native parse); callers record it in hints v2.

    Returns a list of (block_bytes, hints) tuples ((None, None) entries
    for incompressible blocks)."""
    if not blocks:
        return []
    N = _size_class(max(len(b) for b in blocks))
    arr = np.zeros((len(blocks), N), np.uint8)
    ns = np.zeros(len(blocks), np.int32)
    for i, b in enumerate(blocks):
        arr[i, : len(b)] = np.frombuffer(b, np.uint8)
        ns[i] = len(b)
    dists = np.asarray(_find_matches_batch(jnp.asarray(arr), jnp.asarray(ns),
                                           seg, rng, level))
    from ..native.codec import get_codec

    codec = get_codec()
    if codec is None:
        # No native toolchain: per-block slow path (oracle serializer).
        return [encode_block_device(b, seg, rng, level) for b in blocks]
    out = []
    for i, b in enumerate(blocks):
        res = codec.parse_serialize(b, dists[i, : len(b)], seg, rng, level)
        if res is None:
            out.append((None, None))
            continue
        body, hints = res
        if len(body) >= len(b):
            out.append((None, None))
        else:
            out.append((b"\x00" + put_uvarint(len(b)) + body, hints))
    return out


def encode_block_device(data: bytes, seg: int = SEG, rng: int = 0,
                        level: int = 2):
    """Encode one block as concatenated segments with a shared match window.

    Returns (block_bytes, hints) where hints is a list of
    (comp_offset_in_body, out_offset) segment starts for chunk-0x88 emission.
    Returns (None, None) when the data does not compress.
    """
    n = len(data)
    if n == 0:
        return b"\x00", []
    nseg = -(-n // seg)
    # Size-classed padding: small blocks take the smallest power-of-two
    # sort row that holds them instead of the full 64 KiB one.
    N = _size_class(nseg * seg)
    flat = np.zeros(N, np.uint8)
    flat[:n] = np.frombuffer(data, np.uint8)

    dist, length = find_matches(
        jnp.asarray(flat, dtype=jnp.int32)[None, :], n, seg, rng, level
    )
    from ..native.codec import get_codec

    codec = get_codec()
    res = None
    if codec is not None:
        # Fused native parse+serialize: verifies and re-extends every device
        # match proposal byte-exactly (device lengths are only hints).
        dist_np = np.asarray(dist).reshape(-1)[:n]
        res = codec.parse_serialize(data, dist_np, seg, rng, level)
    if res is not None:
        body, hints = res
    else:
        nrows = N // seg
        pos, off, ln, isrep, count = greedy_parse_compact(
            dist.reshape(nrows, seg), length.reshape(nrows, seg), seg, N // 4
        )
        pos, off, ln, isrep, count = (
            np.asarray(pos), np.asarray(off), np.asarray(ln),
            np.asarray(isrep), int(count),
        )
        body, hints = serialize_block(data, pos, off, ln, isrep, count, seg)
    if len(body) >= n:
        # Spec: compressed body must be smaller than the decompressed block;
        # caller falls back to the uncompressed representation.
        return None, None
    return b"\x00" + put_uvarint(n) + body, hints
