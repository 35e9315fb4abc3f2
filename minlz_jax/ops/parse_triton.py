"""Transducer parse as one Pallas kernel through Triton (Hopper decode path).

The parse is a per-lane byte state machine (``transducer.parse_step``): one
step per compressed byte row, every lane (segment) in lockstep.  The plain
form, ``decode_kernel.parse_segments_scan``, is a ``lax.scan`` that XLA
runs as one loop iteration per row.  Here the whole row loop runs inside
one program, with the state in registers:

  * the grid runs over blocks of ``LANE_BLOCK`` lanes; blocks are
    independent and carry nothing between them;
  * each program loops over its rows, up to the longest stream among its
    own lanes (plus the flush row), and zero-fills the rows after that so
    the outputs equal the scan's exactly;
  * the next row's bytes are loaded one iteration ahead, so the load
    latency overlaps the state update.

Input is the compressed bytes as ``[n_rows, lanes]`` uint8 (row = stream
position, column = segment); outputs are the seven ``[n_rows, lanes]``
int32 emission arrays of ``parse_step``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu_triton

from .transducer import init_state, parse_step

# Lanes per program.  The parse is latency-bound along the row loop, so
# narrow programs (one warp, one lane per thread) spread the lanes over the
# most SMs.
LANE_BLOCK = 32
N_EMITS = 7


def _parse_kernel(lens_ref, comp_ref, *out_refs):
    n_rows = comp_ref.shape[0]
    lens = lens_ref[...]
    # Rows this block parses: every lane's stream plus its flush row.
    limit = jnp.minimum(jnp.max(lens) + 1, n_rows)

    def body(row, carry):
        st, byte = carry
        nxt = comp_ref[jnp.minimum(row + 1, n_rows - 1), :].astype(jnp.int32)
        st, emits = parse_step(st, byte, row < lens, row, row == lens)
        for ref, e in zip(out_refs, emits):
            ref[row, :] = e
        return st, nxt

    first = comp_ref[0, :].astype(jnp.int32)
    jax.lax.fori_loop(0, limit, body, (init_state(lens.shape), first))

    zero = jnp.zeros(lens.shape, jnp.int32)

    def fill(row, c):
        for ref in out_refs:
            ref[row, :] = zero
        return c

    jax.lax.fori_loop(limit, n_rows, fill, 0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def parse_segments_triton(comp, lens, interpret: bool = False):
    """comp: [n_rows, lanes] uint8 compressed bytes (column = segment,
    zero padded); lens: [lanes] int32 stream lengths, each < n_rows so
    every lane gets its flush row.  lanes must be a multiple of
    ``LANE_BLOCK``.  Returns the 7 emission arrays [n_rows, lanes] int32
    (kind, dst, clen, csrc, lsrc, llen, lacc), equal to
    ``parse_segments_scan``'s."""
    n_rows, lanes = comp.shape
    if lanes % LANE_BLOCK:
        raise ValueError(f"lanes ({lanes}) must be a multiple of {LANE_BLOCK}")
    out = jax.ShapeDtypeStruct((n_rows, lanes), jnp.int32)
    col = pl.BlockSpec((n_rows, LANE_BLOCK), lambda i: (0, i))
    return tuple(pl.pallas_call(
        _parse_kernel,
        grid=(lanes // LANE_BLOCK,),
        in_specs=[pl.BlockSpec((LANE_BLOCK,), lambda i: (i,)), col],
        out_specs=[col] * N_EMITS,
        out_shape=[out] * N_EMITS,
        backend="triton",
        compiler_params=plgpu_triton.CompilerParams(num_warps=1,
                                                    num_stages=1),
        interpret=interpret,
        name="minlz_parse",
    )(lens, comp))
