"""Byte-lockstep parse transducer for MinLZ decode.

All lanes (segments) consume one compressed byte per step; divergence between
lanes lives in per-lane *state*, never in addressing, so every operation is a
plain vector op — the idiom that makes a sequential byte format parseable
data-parallel (one step = one byte per lane = B bytes across the lanes).

The step function is pure elementwise jnp, so the exact same code runs under
``lax.scan`` (decode_kernel.parse_segments_scan, the plain reference) and
inside the Triton kernel's row loop (parse_triton.py, the GPU path).

Token semantics follow MinLZ SPEC.md §2 (reference decoder
``internal/reference/decoder.go:26``; optimized loop ``decode.go:178``).

Emitted op records (one per row at most; literal runs are HELD and fused
onto the next copy token so most lit+copy pairs cost one executor op):
  kind:  0 = none, 1 = literal-only, 2 = has-copy (may carry fused lits)
  dst:   segment-local output offset of the record (lits first, then copy)
  clen:  copy length (0 for literal-only records)
  csrc:  copy back-reference distance (offset)
  lsrc:  compressed-stream row of the first literal byte
  llen:  literal run length (0 when the copy has no attached literals)
  lacc:  the run's first four literal bytes packed little-endian — free to
         collect here (the transducer touches every byte in lockstep); no
         executor reads it today
A held literal is flushed alone when another literal run begins or at the
end-of-segment flush row (row == segment compressed length).
"""

from __future__ import annotations

import jax.numpy as jnp

# Modes
IDLE, HDR, LIT = 0, 1, 2
# Kinds (internal)
K_LITRUN, K_REPEAT, K_COPY1, K_COPY2, K_COPY3, K_FUSED2 = 0, 1, 2, 3, 4, 5
# Emitted op kinds
OP_NONE, OP_LIT, OP_COPY = 0, 1, 2

STATE_FIELDS = (
    "mode", "kind", "code", "tagval", "litcnt",
    "off_left", "lext_left", "acc_off", "acc_off_cnt", "acc_len",
    "acc_len_cnt", "c3_pend", "c3_off",
    "lit_left", "have_pend", "pend_off", "pend_len",
    "pend_lsrc", "pend_llen",
    "have_lit", "hl_dst", "hl_src", "hl_len",
    "dpos", "rep", "lit_acc", "lit_pos",
)


def init_state(shape):
    st = {f: jnp.zeros(shape, jnp.int32) for f in STATE_FIELDS}
    st["rep"] = jnp.ones(shape, jnp.int32)
    return st


def parse_step(st, byte, active, row, flush=None):
    """One transducer step.

    st:     dict of [lanes]-shaped int32 vectors.
    byte:   [lanes] int32, the compressed byte at this row (garbage where
            inactive).
    active: [lanes] bool, row < segment compressed length.
    row:    scalar int32, current row index.
    flush:  [lanes] bool, row == segment compressed length — the one row
            where a held trailing literal run is emitted alone.

    Returns (new_state, (op_kind, op_dst, op_clen, op_csrc, op_lsrc,
    op_llen)).
    """
    if flush is None:
        flush = jnp.zeros_like(active)
    mode = st["mode"]
    is_idle = active & (mode == IDLE)
    is_hdr = active & (mode == HDR)
    is_lit = active & (mode == LIT)

    # ---------------- IDLE: byte is a tag ---------------------------------
    tag = byte & 3
    val = byte >> 2

    t0 = tag == 0
    t1 = tag == 1
    t2 = tag == 2
    t3 = tag == 3
    c3 = (val & 1) == 1

    # Per-tag header geometry and code extraction.
    code0 = val >> 1  # literal/repeat 5-bit length code
    i_kind = jnp.where(
        t0,
        jnp.where((val & 1) == 1, K_REPEAT, K_LITRUN),
        jnp.where(
            t1,
            K_COPY1,
            jnp.where(t2, K_COPY2, jnp.where(c3, K_COPY3, K_FUSED2)),
        ),
    )
    i_code = jnp.where(
        t0,
        code0,
        jnp.where(
            t1,
            val & 15,
            jnp.where(t2, val, jnp.where(c3, 0, (val >> 3) & 7)),
        ),
    )
    i_off_bytes = jnp.where(
        t0, 0, jnp.where(t1, 1, jnp.where(t2, 2, jnp.where(c3, 3, 2)))
    )
    i_lext = jnp.where(
        t0,
        jnp.maximum(code0 - 28, 0),
        jnp.where(
            t1,
            ((val & 15) == 15).astype(jnp.int32),
            jnp.where(t2, jnp.maximum(val - 60, 0), 0),
        ),
    )
    i_c3_pend = (t3 & c3).astype(jnp.int32)
    i_litcnt = jnp.where(
        t3, jnp.where(c3, (val >> 1) & 3, ((val >> 1) & 3) + 1), 0
    )

    # ---------------- HDR: accumulate header bytes -------------------------
    to_off = is_hdr & (st["off_left"] > 0)
    to_len = is_hdr & (st["off_left"] == 0)
    h_acc_off = jnp.where(
        to_off, st["acc_off"] | (byte << (8 * st["acc_off_cnt"])), st["acc_off"]
    )
    h_acc_off_cnt = st["acc_off_cnt"] + to_off.astype(jnp.int32)
    h_off_left = st["off_left"] - to_off.astype(jnp.int32)
    h_acc_len = jnp.where(
        to_len, st["acc_len"] | (byte << (8 * st["acc_len_cnt"])), st["acc_len"]
    )
    h_acc_len_cnt = st["acc_len_cnt"] + to_len.astype(jnp.int32)
    h_lext_left = st["lext_left"] - to_len.astype(jnp.int32)

    # Copy3 late resolution: after 3 word bytes, length-ext count and the
    # 21-bit offset become known (SPEC.md §2.5.2).
    c3_ready = is_hdr & (st["c3_pend"] == 1) & (h_off_left == 0)
    full = st["tagval"] | (h_acc_off << 6)
    c3_code = (full >> 3) & 63
    c3_off = (full >> 9) + 65536
    h_code = jnp.where(c3_ready, c3_code, st["code"])
    h_c3_off = jnp.where(c3_ready, c3_off, st["c3_off"])
    h_lext_left = jnp.where(c3_ready, jnp.maximum(c3_code - 60, 0), h_lext_left)
    h_c3_pend = jnp.where(c3_ready, 0, st["c3_pend"])

    # ---------------- Merge IDLE/HDR views --------------------------------
    kind = jnp.where(is_idle, i_kind, st["kind"])
    code = jnp.where(is_idle, i_code, h_code)
    tagval = jnp.where(is_idle, val, st["tagval"])
    litcnt = jnp.where(is_idle, i_litcnt, st["litcnt"])
    off_left = jnp.where(is_idle, i_off_bytes, h_off_left)
    lext_left = jnp.where(is_idle, i_lext, h_lext_left)
    acc_off = jnp.where(is_idle, 0, h_acc_off)
    acc_off_cnt = jnp.where(is_idle, 0, h_acc_off_cnt)
    acc_len = jnp.where(is_idle, 0, h_acc_len)
    acc_len_cnt = jnp.where(is_idle, 0, h_acc_len_cnt)
    c3_pend = jnp.where(is_idle, i_c3_pend, h_c3_pend)
    c3_off_v = jnp.where(is_idle, 0, h_c3_off)

    # ---------------- Finalize (token header complete) ---------------------
    fin = (
        (is_idle | is_hdr)
        & (off_left == 0)
        & (lext_left == 0)
        & (c3_pend == 0)
    )

    k_lit = fin & (kind == K_LITRUN)
    k_rep = fin & (kind == K_REPEAT)
    k_c1 = fin & (kind == K_COPY1)
    k_c2 = fin & (kind == K_COPY2)
    k_c3 = fin & (kind == K_COPY3)
    k_f2 = fin & (kind == K_FUSED2)

    lit_len = jnp.where(code < 29, code + 1, acc_len + 30)
    len_c1 = jnp.where(code < 15, code + 4, acc_len + 18)
    len_c23 = jnp.where(code < 61, code + 4, acc_len + 64)
    len_f2 = code + 4

    off_c1 = ((acc_off << 2) | (tagval >> 4)) + 1
    off_c2 = acc_off + 64
    off_f2 = acc_off + 64
    off_c3v = c3_off_v

    # Copy ops that emit immediately (no fused literals).
    imm_copy = k_rep | k_c1 | k_c2 | (k_c3 & (litcnt == 0))
    imm_off = jnp.where(
        k_rep,
        st["rep"],
        jnp.where(k_c1, off_c1, jnp.where(k_c2, off_c2, off_c3v)),
    )
    imm_len = jnp.where(k_rep, lit_len, jnp.where(k_c1, len_c1, len_c23))

    # Ops that enter a literal phase (literal run, fused2, copy3 with lits).
    enter_lit = k_lit | k_f2 | (k_c3 & (litcnt > 0))
    lit_phase_len = jnp.where(k_lit, lit_len, litcnt)
    pend = k_f2 | (k_c3 & (litcnt > 0))
    pend_off_new = jnp.where(k_f2, off_f2, off_c3v)
    pend_len_new = jnp.where(k_f2, len_f2, len_c23)

    # ---------------- LIT phase ------------------------------------------
    lit_left_dec = st["lit_left"] - is_lit.astype(jnp.int32)
    lit_end = is_lit & (lit_left_dec == 0)
    emit_pend = lit_end & (st["have_pend"] == 1)

    # First-four-bytes accumulator of the current literal run.  Only ONE
    # run can be outstanding (a held run flushes when the next one begins,
    # in the same step emission below reads the pre-reset value), so a
    # single register serves plain runs, held runs, and fused literals.
    do_acc = is_lit & (st["lit_pos"] < 4)
    lacc_step = jnp.where(
        do_acc,
        st["lit_acc"] | ((byte & 255) << (8 * st["lit_pos"])),
        st["lit_acc"],
    )
    lpos_step = st["lit_pos"] + is_lit.astype(jnp.int32)

    # ---------------- Emission -------------------------------------------
    # Literal runs are held (have_lit/hl_*) and attached to the next copy;
    # a held lit flushes alone when a new literal phase begins or at the
    # end-of-segment flush row.
    have_lit = st["have_lit"] == 1
    hold_new = enter_lit & k_lit  # plain literal run: hold it
    flush_held = (enter_lit | flush) & have_lit
    emit_comb = imm_copy | emit_pend

    comb_llen = jnp.where(
        emit_pend,
        st["pend_llen"],
        jnp.where(have_lit, st["hl_len"], 0),
    )
    comb_lsrc = jnp.where(
        emit_pend,
        st["pend_lsrc"],
        jnp.where(have_lit, st["hl_src"], 0),
    )
    comb_dst = jnp.where(
        emit_pend,
        st["dpos"] - st["pend_llen"],
        jnp.where(have_lit, st["hl_dst"], st["dpos"]),
    )
    op_kind = jnp.where(
        emit_comb, OP_COPY, jnp.where(flush_held, OP_LIT, OP_NONE)
    )
    op_dst = jnp.where(emit_comb, comb_dst, st["hl_dst"])
    op_clen = jnp.where(
        imm_copy, imm_len, jnp.where(emit_pend, st["pend_len"], 0)
    )
    op_csrc = jnp.where(
        imm_copy, imm_off, jnp.where(emit_pend, st["pend_off"], 0)
    )
    op_lsrc = jnp.where(emit_comb, comb_lsrc, st["hl_src"])
    op_llen = jnp.where(emit_comb, comb_llen, st["hl_len"])
    op_llen = jnp.where(emit_comb | flush_held, op_llen, 0)

    # ---------------- State update ---------------------------------------
    dpos = st["dpos"] + jnp.where(
        enter_lit,
        lit_phase_len,
        jnp.where(imm_copy, imm_len, jnp.where(emit_pend, st["pend_len"], 0)),
    )
    rep = jnp.where(
        k_c1,
        off_c1,
        jnp.where(
            k_c2,
            off_c2,
            jnp.where(
                k_c3, off_c3v, jnp.where(k_f2, off_f2, st["rep"])
            ),
        ),
    )
    new_mode = jnp.where(
        enter_lit,
        LIT,
        jnp.where(
            fin,
            IDLE,  # immediate copies return to idle
            jnp.where(
                is_lit,
                jnp.where(lit_end, IDLE, LIT),
                jnp.where(is_idle | is_hdr, HDR, st["mode"]),
            ),
        ),
    )

    new_st = {
        "mode": jnp.where(active, new_mode, st["mode"]),
        "kind": jnp.where(active, kind, st["kind"]),
        "code": jnp.where(active, code, st["code"]),
        "tagval": jnp.where(active, tagval, st["tagval"]),
        "litcnt": jnp.where(active, litcnt, st["litcnt"]),
        "off_left": jnp.where(active, off_left, st["off_left"]),
        "lext_left": jnp.where(active, lext_left, st["lext_left"]),
        "acc_off": jnp.where(active, acc_off, st["acc_off"]),
        "acc_off_cnt": jnp.where(active, acc_off_cnt, st["acc_off_cnt"]),
        "acc_len": jnp.where(active, acc_len, st["acc_len"]),
        "acc_len_cnt": jnp.where(active, acc_len_cnt, st["acc_len_cnt"]),
        "c3_pend": jnp.where(active, c3_pend, st["c3_pend"]),
        "c3_off": jnp.where(active, c3_off_v, st["c3_off"]),
        "lit_left": jnp.where(
            active,
            jnp.where(enter_lit, lit_phase_len, lit_left_dec),
            st["lit_left"],
        ),
        "have_pend": jnp.where(
            active,
            jnp.where(
                pend, 1, jnp.where(emit_pend, 0, st["have_pend"])
            ),
            st["have_pend"],
        ),
        "pend_off": jnp.where(
            active & pend, pend_off_new, st["pend_off"]
        ),
        "pend_len": jnp.where(
            active & pend, pend_len_new, st["pend_len"]
        ),
        "pend_lsrc": jnp.where(active & pend, row + 1, st["pend_lsrc"]),
        "pend_llen": jnp.where(active & pend, litcnt, st["pend_llen"]),
        "have_lit": jnp.where(
            active & hold_new,
            1,
            jnp.where(
                (active & (emit_comb | (enter_lit & pend))) | flush,
                0,
                st["have_lit"],
            ),
        ),
        "hl_dst": jnp.where(active & hold_new, st["dpos"], st["hl_dst"]),
        "hl_src": jnp.where(active & hold_new, row + 1, st["hl_src"]),
        "hl_len": jnp.where(
            active & hold_new, lit_phase_len, st["hl_len"]
        ),
        "dpos": jnp.where(active, dpos, st["dpos"]),
        "rep": jnp.where(active, rep, st["rep"]),
        "lit_acc": jnp.where(
            active, jnp.where(enter_lit, 0, lacc_step), st["lit_acc"]
        ),
        "lit_pos": jnp.where(
            active, jnp.where(enter_lit, 0, lpos_step), st["lit_pos"]
        ),
    }
    live = active | flush
    emit = (
        jnp.where(live, op_kind, OP_NONE),
        jnp.where(live, op_dst, 0),
        jnp.where(live, op_clen, 0),
        jnp.where(live, op_csrc, 0),
        jnp.where(live, op_lsrc, 0),
        jnp.where(live, op_llen, 0),
        jnp.where(live, lacc_step, 0),
    )
    return new_st, emit
