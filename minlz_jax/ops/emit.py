"""Device token emission: greedy-parse arrays -> exact MinLZ segment bytes.

SURVEY.md §7.0's "prefix-sum token compaction" stage: after the device match
finder and greedy parse, this module verifies every proposed match
byte-exactly ON DEVICE (gather + log-doubling run extension) and then
serializes each segment's token stream with pure parallel primitives —
prefix sums for output cursors, monotone fills for literal-run bases, and
two scatters for byte materialization.  No sequential per-byte loop exists
anywhere; everything is O(log n) depth, which is the data-parallel equivalent
of the reference's byte-at-a-time emitters (asm_none.go:84-353).

The emitted stream mirrors encode_kernel.serialize_segment decision-for-
decision (fused literals when profitable, repeat on offset match, smallest
copy op otherwise; reference analog internal/reference/encoder.go:174-221),
so the two paths are differentially testable byte-for-byte.

Because verification is byte-exact here, the emitted blocks are correct by
construction even for hash-only match proposals (find_matches level 2) —
the same guarantee the fused C++ host serializer provides, now available
without leaving the device.  This is what makes the sharded mesh encode
path (parallel/mesh.py) end-to-end: real bytes, not size estimates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

OUT_PAD = 64  # per-lane output slack beyond the segment size


def _ffill_idx(valid, axis=1):
    """Per-row forward fill: index of the most recent True at or before
    each position (-1 if none)."""
    iota = jax.lax.broadcasted_iota(jnp.int32, valid.shape, axis)
    return jax.lax.cummax(jnp.where(valid, iota, -1), axis=axis)


def _bfill_idx(valid, axis=1):
    """Index of the nearest True at or after each position (-1 if none)."""
    n = valid.shape[axis]
    iota = jax.lax.broadcasted_iota(jnp.int32, valid.shape, axis)
    rev = jnp.flip(
        jax.lax.cummax(
            jnp.flip(jnp.where(valid, n - 1 - iota, -1), axis=axis),
            axis=axis,
        ),
        axis=axis,
    )
    return jnp.where(rev >= 0, n - 1 - rev, -1)


def _run_doubling_flat(ext, cap):
    """runs[i] = length of the consecutive-True run starting at i (1-D)."""
    runs = ext.astype(jnp.int32)
    shift = 1
    while shift < cap:
        carry = jnp.roll(runs, -shift)
        runs = runs + jnp.where(runs == shift, carry, 0)
        shift *= 2
    return runs


def verify_extend(data, take, off, n, seg: int):
    """Byte-exact verification + extension of parsed match proposals.

    data: [N] int32 block bytes (zero padded); take/off: [N] int32 parse
    arrays in global position order; n: valid byte count (traced ok).
    Returns (surv, vlen): surviving takes and their verified lengths.
    """
    N = data.shape[0]
    pos = jnp.arange(N, dtype=jnp.int32)

    # Forward-fill each take's distance over the positions after it, so a
    # single gather verifies every byte: ok[q] = data[q] == data[q - D].
    fi = _ffill_idx(take > 0, axis=0)
    D = jnp.where(fi >= 0, off[jnp.maximum(fi, 0)], 0)
    src = jnp.clip(pos - D, 0, N - 1)
    ok = (D > 0) & (data == data[src]) & (pos < n)

    # Run length of consecutive ok with constant distance, starting at q.
    same = jnp.roll(D, -1) == D
    ext = ok & jnp.roll(ok, -1) & same
    runs = _run_doubling_flat(ext, min(seg, 8192))
    mlen = jnp.where(ok, 1 + runs, 0)

    # Caps: segment boundary, block end, and the next take's position
    # (extension past it would double-cover its output).
    seg_room = seg - (pos % seg)
    nxt = _bfill_idx(jnp.roll(take > 0, -1) & (pos + 1 < N), axis=0)
    # nearest take strictly after q: index of next take at or after q+1
    nxt_pos = jnp.where(nxt >= 0, nxt + 1, N)
    gap = nxt_pos - pos
    vlen = jnp.minimum(jnp.minimum(mlen, seg_room), jnp.minimum(gap, n - pos))
    vlen = jnp.where(take > 0, vlen, 0)
    surv = (take > 0) & (vlen >= 4)
    return surv.astype(jnp.int32), jnp.where(surv, vlen, 0)


def _lit_hdr(nl):
    """Literal-run header bytes/length for runs < 65566 (seg-bounded)."""
    b0 = jnp.where(
        nl < 30, (nl - 1) << 3, jnp.where(nl < 286, 29 << 3, 30 << 3)
    )
    b1 = jnp.where(nl < 286, nl - 30, (nl - 30) & 255)
    b2 = (nl - 30) >> 8
    ln = jnp.where(nl < 30, 1, jnp.where(nl < 286, 2, 3))
    ln = jnp.where(nl > 0, ln, 0)
    return jnp.stack([b0, b1, b2], -1), ln


def _rep_tok(l):
    v = l - 1
    v2 = l - 30
    b0 = jnp.where(v < 29, v << 3 | 4, jnp.where(v2 < 256, 29 << 3 | 4, 30 << 3 | 4))
    b1 = jnp.where(v2 < 256, v2, v2 & 255)
    b2 = v2 >> 8
    ln = jnp.where(v < 29, 1, jnp.where(v2 < 256, 2, 3))
    return jnp.stack([b0, b1, b2], -1), ln


def _copy_tok(off, l):
    """Copy token bytes for the non-fused path (copy1/2/3 incl. repeat
    extension for long copy1).  Returns (bytes [..,7], len)."""
    z = jnp.zeros_like(off)
    # copy1 (off <= 1024)
    o1 = off - 1
    x_s = o1 << 6 | (l - 4) << 2 | 1          # short, l<=18
    x_m = o1 << 6 | 15 << 2 | 1               # +1 ext, l<=273
    x_l = o1 << 6 | 14 << 2 | 1               # l=18 + repeat(l-18)
    rep_b, rep_l = _rep_tok(jnp.maximum(l - 18, 1))
    c1b = jnp.where(
        (l <= 18)[..., None],
        jnp.stack([x_s & 255, x_s >> 8, z, z, z, z, z], -1),
        jnp.where(
            (l <= 273)[..., None],
            jnp.stack([x_m & 255, x_m >> 8, l - 18, z, z, z, z], -1),
            jnp.stack(
                [x_l & 255, x_l >> 8, rep_b[..., 0], rep_b[..., 1],
                 rep_b[..., 2], z, z], -1,
            ),
        ),
    )
    c1l = jnp.where(l <= 18, 2, jnp.where(l <= 273, 3, 2 + rep_l))
    # copy2 (64 <= off <= 65599); l2 <= 8192-4 so <=2 ext bytes
    o2 = off - 64
    l2 = l - 4
    c2b = jnp.where(
        (l2 <= 60)[..., None],
        jnp.stack([l2 << 2 | 2, o2 & 255, o2 >> 8, z, z, z, z], -1),
        jnp.where(
            (l2 - 60 < 256)[..., None],
            jnp.stack(
                [z + (61 << 2 | 2), o2 & 255, o2 >> 8, l2 - 60, z, z, z], -1
            ),
            jnp.stack(
                [z + (62 << 2 | 2), o2 & 255, o2 >> 8, (l2 - 60) & 255,
                 (l2 - 60) >> 8, z, z], -1,
            ),
        ),
    )
    c2l = jnp.where(l2 <= 60, 3, jnp.where(l2 - 60 < 256, 4, 5))
    # copy3 (off > 65599) with no fused literals
    c3b, c3l = _copy3_tok(off, l, z)
    return (
        jnp.where(
            (off <= 1024)[..., None],
            c1b,
            jnp.where((off <= 65599)[..., None], c2b, c3b),
        ),
        jnp.where(off <= 1024, c1l, jnp.where(off <= 65599, c2l, c3l)),
    )


def _copy3_tok(off, l, nlits):
    """Copy3 token bytes (ext bytes precede fused literal data)."""
    z = jnp.zeros_like(off)
    o = off - 65536
    l3 = l - 4
    code = jnp.where(l3 <= 60, l3, jnp.where(l3 - 60 < 256, 61, 62))
    word = 7 | nlits << 3 | code << 5 | o << 11
    ext = l3 - 60
    b = jnp.stack(
        [word & 255, (word >> 8) & 255, (word >> 16) & 255,
         (word >> 24) & 255,
         jnp.where(code >= 61, ext & 255, z),
         jnp.where(code >= 62, ext >> 8, z), z], -1,
    )
    ln = 4 + jnp.where(code >= 61, 1, 0) + jnp.where(code >= 62, 1, 0)
    return b, ln


@functools.partial(jax.jit, static_argnames=("seg",))
def emit_segments(data, surv, off, vlen, n, seg: int):
    """Serialize verified tokens into per-segment MinLZ byte streams.

    data: [N] int32 block bytes; surv/off/vlen: [N] verified parse arrays;
    n: valid bytes (traced ok).  N must be a multiple of seg.
    Returns (out [nseg, seg + OUT_PAD] uint8, out_lens [nseg] int32).
    """
    N = data.shape[0]
    nseg = N // seg
    S = seg
    shape = (nseg, S)
    d = data.reshape(shape)
    take = surv.reshape(shape) > 0
    off = off.reshape(shape)
    ln = vlen.reshape(shape)
    pos = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    gpos = pos + jnp.arange(nseg, dtype=jnp.int32)[:, None] * S
    seg_n = jnp.clip(n - jnp.arange(nseg, dtype=jnp.int32)[:, None] * S, 0, S)

    # --- run geometry -----------------------------------------------------
    # cover end (exclusive) of the most recent token at or before q.
    cov = jax.lax.cummax(jnp.where(take, pos + ln, 0), axis=1)
    lit_start = jnp.where(take, jnp.roll(cov, 1, axis=1), 0)
    lit_start = lit_start.at[:, 0].set(0)
    # tokens never start inside a previous token's span (greedy parse), so
    # lit_start at a take is the previous cover end.
    nlits = jnp.where(take, pos - lit_start, 0)

    # previous surviving take's offset (repeat detection).
    prev_i = jnp.roll(_ffill_idx(take, axis=1), 1, axis=1)
    prev_i = prev_i.at[:, 0].set(-1)
    rep_prev = jnp.where(
        prev_i >= 0, jnp.take_along_axis(off, jnp.maximum(prev_i, 0), 1), -1
    )

    # --- token selection (mirrors serialize_segment) ----------------------
    is_rep = take & (off == rep_prev)
    can_fuse = (
        take
        & (nlits >= 1)
        & (off >= 64)
        & ~is_rep
        & ((nlits <= 3) | ((off <= 65599) & (nlits <= 4)))
    )
    fuse2 = can_fuse & (off <= 65599)
    fuse3 = can_fuse & (off > 65599)

    lit_b, lit_l = _lit_hdr(nlits)
    rep_b, rep_l = _rep_tok(jnp.maximum(ln, 1))
    cop_b, cop_l = _copy_tok(jnp.maximum(off, 1), jnp.maximum(ln, 4))
    c3f_b, c3f_l = _copy3_tok(
        jnp.maximum(off, 65600), jnp.maximum(ln, 4), nlits
    )
    # fused2: 3-byte token; l>7 adds a repeat extension after the literals.
    o2 = off - 64
    l2 = jnp.maximum(ln, 4) - 4
    f2code = jnp.minimum(l2, 7)
    f2_b = jnp.stack(
        [3 | (nlits - 1) << 3 | f2code << 5, o2 & 255, o2 >> 8], -1
    )
    f2ext_b, f2ext_l = _rep_tok(jnp.maximum(ln - 11, 1))
    f2ext_l = jnp.where(l2 > 7, f2ext_l, 0)

    # prefix = bytes before the run's literal data; suffix = bytes after.
    zero7 = jnp.zeros(shape + (7,), jnp.int32)

    def pad7(b):
        return jnp.concatenate(
            [b, jnp.zeros(shape + (7 - b.shape[-1],), jnp.int32)], -1
        )

    pre_b = jnp.where(
        fuse2[..., None],
        pad7(f2_b),
        jnp.where(fuse3[..., None], c3f_b, pad7(lit_b)),
    )
    pre_l = jnp.where(
        fuse2, 3, jnp.where(fuse3, c3f_l, jnp.where(nlits > 0, lit_l, 0))
    )
    suf_b = jnp.where(
        is_rep[..., None],
        pad7(rep_b),
        jnp.where(
            fuse2[..., None],
            pad7(f2ext_b),
            jnp.where(fuse3[..., None], zero7, cop_b),
        ),
    )
    suf_l = jnp.where(
        is_rep, rep_l, jnp.where(fuse2, f2ext_l, jnp.where(fuse3, 0, cop_l))
    )
    pre_l = jnp.where(take, pre_l, 0)
    suf_l = jnp.where(take, suf_l, 0)

    # --- output cursors ---------------------------------------------------
    tok_total = pre_l + nlits + suf_l
    csum = jnp.cumsum(tok_total, axis=1)
    out_before = csum - tok_total  # exclusive
    data_base = out_before + pre_l

    # trailing literal flush per lane
    last_cov = cov[:, -1:]
    trail = jnp.maximum(seg_n - last_cov, 0)
    fl_b, fl_l = _lit_hdr(jnp.maximum(trail, 1))
    fl_l = jnp.where(trail > 0, fl_l, 0)
    flush_base = csum[:, -1:]
    out_lens = (flush_base + fl_l + trail).reshape(nseg)

    # --- literal byte addresses (backward fill of data_base - lit_start) --
    C_tok = jnp.where(take, data_base - lit_start, 0)
    nx = _bfill_idx(take, axis=1)
    C_fill = jnp.where(
        nx >= 0,
        jnp.take_along_axis(C_tok, jnp.maximum(nx, 0), 1),
        flush_base + fl_l - last_cov,  # flush run
    )
    is_lit = (cov <= pos) & (pos < seg_n)
    OUT = S + OUT_PAD
    lit_addr = jnp.where(is_lit, C_fill + pos, OUT)

    out = jnp.full((nseg, OUT), 0, jnp.int32)
    out = jax.vmap(
        lambda o, a, v: o.at[a].set(v, mode="drop")
    )(out, lit_addr, d)

    # --- token/header byte scatter ----------------------------------------
    j = jnp.arange(7, dtype=jnp.int32)
    pre_addr = jnp.where(
        take[..., None] & (j < pre_l[..., None]),
        out_before[..., None] + j,
        OUT,
    )
    suf_addr = jnp.where(
        take[..., None] & (j < suf_l[..., None]),
        (out_before + pre_l + nlits)[..., None] + j,
        OUT,
    )
    out = jax.vmap(
        lambda o, a, v: o.at[a.reshape(-1)].set(v.reshape(-1), mode="drop")
    )(out, pre_addr, pre_b)
    out = jax.vmap(
        lambda o, a, v: o.at[a.reshape(-1)].set(v.reshape(-1), mode="drop")
    )(out, suf_addr, suf_b)

    # flush headers (3 bytes max) at flush_base
    fj = jnp.arange(3, dtype=jnp.int32)
    fl_addr = jnp.where(
        (trail > 0) & (fj < fl_l), flush_base + fj, OUT
    )
    out = jax.vmap(
        lambda o, a, v: o.at[a].set(v, mode="drop")
    )(out, fl_addr, fl_b.reshape(nseg, 3))

    return out.astype(jnp.uint8), out_lens


@functools.partial(jax.jit, static_argnames=("seg", "rng", "level", "ctx"))
def encode_block_emit(data_flat, n, seg: int, rng: int = 0, level: int = 2,
                      ctx: int = 0):
    """Full device encode: match find -> greedy parse -> verify ->
    emit.  data_flat: [1, N] int32; returns (out [nseg, seg+OUT_PAD] uint8,
    out_lens [nseg]).  Correct by construction (byte-exact verification);
    usable standalone or under vmap/shard_map.

    ctx > 0: the first ``ctx`` segments are dictionary/context history —
    match finding, parsing and verification see them (copies may reach
    back into them), but serialization covers only the remaining
    ``nseg - ctx`` block segments, so dict-mode encode does no wasted
    emission work (r3 advisor finding on parallel/mesh.py)."""
    from . import encode_kernel as ek

    N = data_flat.shape[1]
    dist, length = ek.find_matches_dyn(data_flat, n, seg, rng, level)
    nseg = N // seg
    take, tok_off, tok_len, _ = ek.greedy_parse(
        dist.reshape(nseg, seg), length.reshape(nseg, seg), seg
    )
    surv, vlen = verify_extend(
        data_flat.reshape(-1), take.reshape(-1), tok_off.reshape(-1), n, seg
    )
    C = ctx * seg
    flat = data_flat.reshape(-1)
    return emit_segments(
        flat[C:], surv[C:], tok_off.reshape(-1)[C:], vlen[C:], n - C, seg
    )
