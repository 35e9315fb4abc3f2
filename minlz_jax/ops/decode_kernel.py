"""Batched segment decode, plain reference: transducer parse + host executor.

Pipeline (per batch of segments):
  1. Host packs ragged compressed segments into a [P, B] byte matrix
     (column = segment), P = max compressed length.
  2. Parse: the byte-lockstep transducer emits per-row op records
     (kind/dst/len/src), one vector step per compressed byte row.
  3. Execute: op records are walked in segment order; literal runs copy
     from the compressed matrix, copies replicate earlier output.

``parse_segments_scan`` (lax.scan) and ``execute_ops_host`` (NumPy) are the
plain references for the device path: the Triton parse kernel
(parse_triton.py) must equal the first, the XLA executor (executor.py) the
second.

Reference behavior: decode.go:178 (minLZDecodeGo); this design replaces its
sequential byte machine with parse-then-execute per BASELINE.json.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .transducer import OP_COPY, OP_LIT, init_state, parse_step


def pack_segments(seg_bytes_list):
    """Pack ragged compressed segments into a [P, B] int32 matrix + lengths.

    Returns (matrix[P, B] int32, lengths[B] int32).
    """
    B = len(seg_bytes_list)
    P = max((len(s) for s in seg_bytes_list), default=1)
    P = max(P, 1)
    # Bucket P to limit jit recompiles; strictly greater than every length
    # so each lane has a flush row (row == len) for trailing literals.
    P = 1 << P.bit_length()
    mat = np.zeros((P, B), dtype=np.int32)
    lens = np.zeros((B,), dtype=np.int32)
    for b, s in enumerate(seg_bytes_list):
        a = np.frombuffer(bytes(s), dtype=np.uint8)
        mat[: len(a), b] = a
        lens[b] = len(a)
    return mat, lens


@jax.jit
def parse_segments_scan(mat, lens):
    """Run the transducer over all rows via lax.scan.

    mat:  [P, B] int32 compressed bytes (0-255).
    lens: [B] int32 compressed lengths.
    Returns op arrays, each [P, B] int32: kind, dst, len, src.
    """
    B = mat.shape[1]
    st0 = init_state((B,))

    def step(carry, inp):
        st, row = carry
        byte = inp
        active = row < lens
        flush = row == lens
        st, emit = parse_step(st, byte, active, row, flush)
        return (st, row + 1), emit

    (_, _), emits = jax.lax.scan(step, (st0, jnp.int32(0)), mat)
    return emits  # (kind, dst, clen, csrc, lsrc, llen, lacc) each [P, B]


def execute_ops_host(op_kind, op_dst, op_clen, op_csrc, op_lsrc, op_llen,
                     mat, out_lens):
    """Reference executor: walk op records per segment (NumPy, host).

    The segments are consecutive parts of one block: segment b's output
    follows segment b-1's, and a copy may reach back into any earlier
    segment's output.  Each record places its fused literal run (llen bytes
    from the compressed matrix at lsrc) at dst, then its copy (clen from
    csrc back) at dst + llen.  Returns list of decoded bytes per segment.
    """
    op_kind = np.asarray(op_kind)
    op_dst = np.asarray(op_dst)
    op_clen = np.asarray(op_clen)
    op_csrc = np.asarray(op_csrc)
    op_lsrc = np.asarray(op_lsrc)
    op_llen = np.asarray(op_llen)
    mat = np.asarray(mat).astype(np.uint8)
    P, B = op_kind.shape
    bases = np.concatenate([[0], np.cumsum(out_lens[:B])]).astype(np.int64)
    out = np.zeros(int(bases[-1]), dtype=np.uint8)
    for b in range(B):
        base = int(bases[b])
        rows = np.nonzero(op_kind[:, b])[0]
        for p in rows:
            dst = base + int(op_dst[p, b])
            llen = int(op_llen[p, b])
            if llen:
                src = int(op_lsrc[p, b])
                out[dst : dst + llen] = mat[src : src + llen, b]
                dst += llen
            ln = int(op_clen[p, b])
            if ln:
                off = int(op_csrc[p, b])
                if off > dst:
                    raise ValueError(
                        f"segment {b}: copy offset {off} exceeds position {dst}"
                    )
                s = dst - off
                if off >= ln:
                    out[dst : dst + ln] = out[s : s + ln]
                else:
                    # Overlap: byte-serial copy semantics make the result
                    # periodic with period `off` (out[d+i] = out[s + i%off]).
                    reps = -(-ln // off)
                    out[dst : dst + ln] = np.tile(out[s:dst], reps)[:ln]
    return [out[bases[b] : bases[b + 1]].tobytes() for b in range(B)]


def decode_segments_jnp(seg_bytes_list, out_lens):
    """Decode a batch of segments: scan parse + host execute (reference)."""
    mat, lens = pack_segments(seg_bytes_list)
    emits = parse_segments_scan(jnp.asarray(mat), jnp.asarray(lens))
    return execute_ops_host(*emits[:6], mat, out_lens)
