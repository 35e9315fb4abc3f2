"""Device-mesh data parallelism over independent blocks.

The reference's concurrency model is goroutines + an ordered channel of
channels (writer.go:214-272).  The device equivalent (SURVEY.md §2.14):

  * blocks are sharded data-parallel over a 1-D mesh axis ("blocks"); the
    cards are joined all to all, so the mesh follows the algorithm alone;
  * every device runs the match-find/parse pipeline on its own blocks;
  * per-block compressed sizes are exchanged with an all-gather;
  * stream assembly order = exclusive prefix sum of sizes (a deterministic
    scan replaces the reference's channel ordering);
  * dictionaries/configs broadcast once (replicated sharding).

Multi-host extends the same mesh over DCN via ``jax.distributed.initialize``;
nothing below changes because shard_map only sees the global mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import encode_kernel


def make_mesh(devices=None, axis: str = "blocks") -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def sharded_decode_parse(mesh: Mesh, comp_mat, comp_lens):
    """Data-parallel decode parse over a mesh: each device runs the
    byte-lockstep transducer on its own blocks' segment matrices, then
    per-block op counts are all-gathered and scanned so every device knows
    the deterministic global op offsets (stream-order assembly without the
    reference's channel ordering; reader.go:612-668 equivalent).

    comp_mat:  [n_blocks, P, S] int32 packed compressed bytes (column =
               segment), sharded over the mesh's first axis.
    comp_lens: [n_blocks, S] int32 per-segment compressed lengths (< P).
    Returns (op arrays [n_blocks, P, S] x7, global op offsets [n_blocks]).
    """
    from ..ops.decode_kernel import parse_segments_scan

    axis = mesh.axis_names[0]

    def per_device(mat, lens):
        emits = jax.vmap(parse_segments_scan)(mat, lens)
        ops = jnp.sum(emits[0] > 0, axis=(1, 2), dtype=jnp.int32)
        all_ops = jax.lax.all_gather(ops, axis).reshape(-1)
        offs = jnp.cumsum(all_ops) - all_ops
        my = jax.lax.axis_index(axis)
        local = ops.shape[0]
        my_offs = jax.lax.dynamic_slice(offs, (my * local,), (local,))
        return (*emits, my_offs)

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None)),
        out_specs=(*([P(axis, None, None)] * 7), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)(comp_mat, comp_lens)


def sharded_encode_blocks(mesh: Mesh, data_blocks, n_valid, seg: int = 4096,
                          rng: int = 0, level: int = 2,
                          collectives: bool = True):
    """End-to-end data-parallel block encode over a mesh: REAL bytes out.

    data_blocks: [n_blocks, N] int32 byte array (N window-padded), sharded
    over the mesh's first axis; n_valid: [n_blocks] int32 valid byte counts.

    Per device: match find -> greedy parse -> byte-exact verify -> token
    emission (ops/emit.py), all on device.  Per-block compressed sizes are
    all-gathered and exclusive-scanned into deterministic stream
    offsets — the reference's ordered channel-of-channels (writer.go:214-272)
    replaced by a collective prefix sum.  ``collectives=False`` skips the
    exchange (offsets come back zero) so harnesses can measure the
    collective phase's cost in isolation.

    Returns (seg_bytes [n_blocks, nseg, seg+PAD] uint8,
             seg_lens [n_blocks, nseg] int32,
             block_sizes [n_blocks] int32,
             stream_offsets [n_blocks] int32).
    """
    from ..ops import emit

    axis = mesh.axis_names[0]

    def per_device(blocks, valid):
        def one(b, nv):
            return emit.encode_block_emit(b[None, :], nv, seg, rng, level)

        out, lens = jax.vmap(one)(blocks, valid)
        sizes = jnp.sum(lens, axis=1)
        if not collectives:
            return out, lens, sizes, jnp.zeros_like(sizes)
        all_sizes = jax.lax.all_gather(sizes, axis).reshape(-1)
        offsets = jnp.cumsum(all_sizes) - all_sizes
        my = jax.lax.axis_index(axis)
        local = sizes.shape[0]
        my_offs = jax.lax.dynamic_slice(offsets, (my * local,), (local,))
        return out, lens, sizes, my_offs

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis)),
        out_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)(data_blocks, n_valid)


def sharded_encode_blocks_dict(mesh: Mesh, dict_arr, data_blocks, n_valid,
                               seg: int = 4096):
    """Dict-aware data-parallel encode: ONE dictionary broadcast to every
    device (replicated sharding), blocks sharded over the mesh axis.

    dict_arr: [D] int32 dictionary bytes, D a multiple of ``seg`` (pad at
    the FRONT and hand the padded bytes to the decoder as its dict — match
    verification is byte-exact, so pad bytes are never falsely referenced).
    data_blocks: [n_blocks, N] int32; n_valid: [n_blocks].

    Every block is encoded against the shared dictionary context: the
    match finder sees [dict || block], emission covers only the block's
    segments, and copies may reach back into the dictionary (decode with
    ``native.codec.decode_block_dict`` / oracle dict decode).  The range
    clamp is off in dict mode — dictionary references cross ranges by
    design, so these blocks take the v1 decode path.

    Reference analog: dict-candidate encode (encode_l2.go:607,
    encode_l3.go:278-296) under writer concurrency (writer.go:214-272),
    with the broadcast replacing per-goroutine dict pointer sharing.

    Returns (seg_bytes [n_blocks, nseg, seg+PAD] uint8,
             seg_lens [n_blocks, nseg] int32,
             block_sizes [n_blocks] int32,
             stream_offsets [n_blocks] int32).
    """
    from ..ops import emit

    axis = mesh.axis_names[0]
    D = dict_arr.shape[0]
    if D % seg:
        raise ValueError("dictionary length must be a multiple of seg "
                         "(front-pad and use the padded dict to decode)")
    dseg = D // seg

    def per_device(dict_rep, blocks, valid):
        def one(dict_r, b, nv):
            combined = jnp.concatenate([dict_r, b])
            # ctx=dseg: the dict segments feed match finding/verification
            # but are never serialized — no wasted emission work.
            return emit.encode_block_emit(
                combined[None, :], nv + D, seg, 0, ctx=dseg
            )

        out, lens = jax.vmap(one, in_axes=(None, 0, 0))(
            dict_rep, blocks, valid
        )
        sizes = jnp.sum(lens, axis=1)
        all_sizes = jax.lax.all_gather(sizes, axis).reshape(-1)
        offsets = jnp.cumsum(all_sizes) - all_sizes
        my = jax.lax.axis_index(axis)
        local = sizes.shape[0]
        my_offs = jax.lax.dynamic_slice(offsets, (my * local,), (local,))
        return out, lens, sizes, my_offs

    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(axis)),
        out_specs=(P(axis, None, None), P(axis, None), P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)(dict_arr, data_blocks, n_valid)


def assemble_blocks(seg_bytes, seg_lens, n_valid, seg: int = 4096):
    """Host assembly: per-block spec-valid MinLZ blocks from sharded
    emission output (None entry = incompressible, caller stores raw)."""
    from ..minlz import put_uvarint

    seg_bytes = np.asarray(seg_bytes)
    seg_lens = np.asarray(seg_lens)
    blocks = []
    for bi in range(seg_bytes.shape[0]):
        n = int(n_valid[bi])
        nseg = -(-n // seg)
        body = b"".join(
            seg_bytes[bi, i, : seg_lens[bi, i]].tobytes()
            for i in range(nseg)
        )
        if len(body) >= n:
            blocks.append(None)
        else:
            blocks.append(b"\x00" + put_uvarint(n) + body)
    return blocks


def sharded_pipeline_step(mesh: Mesh, data_blocks, n_valid, seg: int = 4096):
    """One data-parallel encode pipeline step over a mesh.

    data_blocks: [n_blocks, block_size] int32 byte array, sharded over the
    mesh's "blocks" axis (n_blocks must be a multiple of the axis size).
    n_valid: [n_blocks] int32 valid byte counts.

    Per device: full match finding + greedy parse for its blocks; then an
    all-gather of per-block compressed-size estimates and an exclusive scan
    to produce deterministic stream output offsets.

    Returns (take, tok_off, tok_len, est_sizes, out_offsets).
    """
    axis = mesh.axis_names[0]

    def per_device(blocks, valid):
        # blocks: [local_blocks, block_size]
        def one_block(b, nv):
            dist, length = encode_kernel.find_matches_dyn(b[None, :], nv, seg)
            nsegs = b.shape[0] // seg
            take, tok_off, tok_len, is_rep = encode_kernel.greedy_parse(
                dist.reshape(nsegs, seg), length.reshape(nsegs, seg), seg
            )
            # Estimated compressed size: 3 bytes per token + literals.
            covered = jnp.sum(tok_len)
            toks = jnp.sum(take)
            est = toks * 3 + (nv - covered)
            return take, tok_off, tok_len, est

        take, tok_off, tok_len, est = jax.vmap(one_block)(blocks, valid)
        # Exchange sizes; offsets = exclusive prefix sum in global
        # block order (deterministic stream assembly).
        all_sizes = jax.lax.all_gather(est, axis)  # [n_dev, local]
        flat = all_sizes.reshape(-1)
        offsets = jnp.cumsum(flat) - flat
        my = jax.lax.axis_index(axis)
        local = est.shape[0]
        my_offsets = jax.lax.dynamic_slice(offsets, (my * local,), (local,))
        return take, tok_off, tok_len, est, my_offsets

    spec = P(axis)
    fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(axis, None), spec),
        out_specs=(P(axis, None), P(axis, None), P(axis, None), spec, spec),
        check_vma=False,
    )
    return jax.jit(fn)(data_blocks, n_valid)
