"""Stream-facing device codec: block encode/decode + parse-hint wire format.

Parse hints (user-skippable chunk 0x88, an extension of this codec): emitted
before each compressed data chunk, they record where each fixed-size output
segment's token stream begins, making the block decodable segment-parallel in
lockstep lanes.  Spec-conformant readers skip the chunk; the block itself stays 100%
standard MinLZ.

Payload v1: "MZPH" + 0x01 + uvarint(segment_size) + uvarint(n_segments)
+ delta-uvarint compressed offsets (first absolute, then deltas).
Payload v2: same with version 0x02 and uvarint(range) inserted after
n_segments — `range` > 0 guarantees every match source lies in the
range-aligned window of its destination.  The device decoder
(executor.py) resolves copies anywhere in the block, so it reads both
versions alike; the field stays on the wire for other decoders.
"""

from __future__ import annotations

from ..minlz import MAX_BLOCK_SIZE, CorruptError, put_uvarint, read_uvarint

HINT_MAGIC = b"MZPH"
HINT_VERSION = 2


def marshal_hints(seg_size: int, hints, rng: int = 0) -> bytes:
    """hints: list of (comp_offset, out_offset); out offsets are implied by
    the fixed segment size, so only comp offsets go on the wire."""
    out = bytearray(HINT_MAGIC)
    out.append(HINT_VERSION)
    out += put_uvarint(seg_size)
    out += put_uvarint(len(hints))
    out += put_uvarint(rng)
    prev = 0
    for coff, _ in hints:
        out += put_uvarint(coff - prev)
        prev = coff
    return bytes(out)


def parse_hints(payload: bytes):
    """Returns (seg_size, [comp_offset...], rng) or raises CorruptError."""
    if payload[:4] != HINT_MAGIC or len(payload) < 5:
        raise CorruptError("bad parse-hint magic")
    version = payload[4]
    if version not in (1, 2):
        raise CorruptError(f"unsupported parse-hint version {version}")
    try:
        pos = 5
        seg_size, pos = read_uvarint(payload, pos)
        n, pos = read_uvarint(payload, pos)
        rng = 0
        if version >= 2:
            rng, pos = read_uvarint(payload, pos)
        offs = []
        cur = 0
        for _ in range(n):
            d, pos = read_uvarint(payload, pos)
            cur += d
            offs.append(cur)
    except ValueError as exc:  # truncated or overflowing varint
        raise CorruptError(f"bad parse-hint payload: {exc}") from exc
    return seg_size, offs, rng


def split_body(body: bytes, comp_offsets):
    """Slice a block body into per-segment token streams."""
    segs = []
    for i, off in enumerate(comp_offsets):
        end = comp_offsets[i + 1] if i + 1 < len(comp_offsets) else len(body)
        segs.append(body[off:end])
    return segs


class DeviceCodec:
    """Block codec backed by the device kernels, for the stream layer.

    encode(data, level) -> (chunk_body_without_marker, hint_payload) | None
    decode(body, hint_payload, decoded_len) -> bytes
    """

    def __init__(self):
        from . import encode_kernel, executor

        self._enc = encode_kernel
        self._exec = executor

    @staticmethod
    def _seg_for(n: int) -> int:
        """Segment size scaling: <=2MiB blocks use 4KiB segments (256-512
        lanes); bigger blocks grow segments so 8MiB still fits 512 lanes."""
        seg = 4096
        while n > seg * 512:
            seg *= 2
        return seg

    # Stream levels map onto device effort tiers: LEVEL_SUPER_FAST (-1)
    # drops sort passes, 1/2 scale tier count, LEVEL_SMALLEST (3) deepens
    # candidate sets and relaxes the emit profit gate (see
    # encode_kernel.find_matches_dyn and codec.cpp parse_serialize_range;
    # reference per-level machines encode_l0.go:32..encode_l3.go:38).
    def encode(self, data: bytes, level: int = 2):
        seg = self._seg_for(len(data))
        rng = self._enc.RANGE
        block, hints = self._enc.encode_block_device(
            bytes(data), seg, rng, level
        )
        if block is None:
            return None
        # Strip the 0x00 marker + uvarint for stream framing is done by the
        # caller; here return the full block plus the hint payload.
        return block, marshal_hints(seg, hints, rng)

    def encode_emit(self, data: bytes, level: int = 2):
        """FULLY on-device encode: match find -> greedy parse -> byte-exact
        verify -> token emission all on device (ops/emit.py); the host only
        frames the header.  Byte-exact by construction, at a ~7-point
        ratio cost against the fused host serializer — this path exists
        for host-CPU-free pipelines and the sharded mesh writer
        (parallel/mesh.py).  Reference emitters: asm_none.go:84-353."""
        import jax.numpy as jnp
        import numpy as np

        from ..minlz import put_uvarint
        from . import encode_kernel as ek
        from ..ops import emit

        n = len(data)
        if n == 0:
            return None
        seg = self._seg_for(n)
        rng = self._enc.RANGE
        N = -(-max(n, 1) // seg) * seg
        N = -(-N // (2 * ek.WINDOW)) * (2 * ek.WINDOW)
        flat = np.zeros(N, np.uint8)
        flat[:n] = np.frombuffer(bytes(data), np.uint8)
        out, lens = emit.encode_block_emit(
            jnp.asarray(flat, jnp.int32)[None, :], n, seg, rng, level
        )
        lens = np.asarray(lens)
        out = np.asarray(out)
        nseg = -(-n // seg)
        body = b"".join(
            out[i, : lens[i]].tobytes() for i in range(nseg)
        )
        if len(body) >= n:
            return None
        offs = np.concatenate([[0], np.cumsum(lens[:nseg])[:-1]])
        hints = [(int(o), i * seg) for i, o in enumerate(offs)]
        block = b"\x00" + put_uvarint(n) + body
        return block, marshal_hints(seg, hints, rng)

    def _emit_batch_arrays(self, blocks, level: int, mesh=None):
        """Shared batched device-emit core: pad blocks to one window-sized
        geometry, emit every block's token streams in ONE dispatch (vmap on
        a single chip, or ``shard_map`` data-parallel over ``mesh``), and
        return (block, hint_payload) | None entries in submission order."""
        import jax.numpy as jnp
        import numpy as np

        from ..minlz import put_uvarint
        from . import encode_kernel as ek

        rng = self._enc.RANGE
        seg = self._seg_for(max(len(b) for b in blocks))
        N = -(-max(max(len(b) for b in blocks), 1) // seg) * seg
        N = -(-N // (2 * ek.WINDOW)) * (2 * ek.WINDOW)
        B = len(blocks)
        if mesh is not None:
            ax = mesh.devices.size
            B = -(-B // ax) * ax  # pad batch to the mesh axis size
        arr = np.zeros((B, N), np.int32)
        ns = np.zeros((B,), np.int32)
        for i, b in enumerate(blocks):
            arr[i, : len(b)] = np.frombuffer(bytes(b), np.uint8)
            ns[i] = len(b)
        ns = np.maximum(ns, 1)  # emit needs >= 1 segment per lane

        if mesh is not None:
            from ..parallel.mesh import sharded_encode_blocks

            out, lens, _sizes, _offs = sharded_encode_blocks(
                mesh, jnp.asarray(arr), jnp.asarray(ns), seg=seg,
                rng=rng, level=level,
            )
        else:
            from . import emit

            def one(b, nv):
                return emit.encode_block_emit(
                    b[None, :], nv, seg, rng, level
                )

            import jax

            out, lens = jax.jit(jax.vmap(one))(
                jnp.asarray(arr), jnp.asarray(ns)
            )
        out = np.asarray(out)
        lens = np.asarray(lens)

        results = []
        for i, b in enumerate(blocks):
            n = len(b)
            if n == 0:
                results.append(None)
                continue
            nseg = -(-n // seg)
            body = b"".join(
                out[i, s, : lens[i, s]].tobytes() for s in range(nseg)
            )
            if len(body) >= n:
                results.append(None)
                continue
            offs = np.concatenate([[0], np.cumsum(lens[i, :nseg])[:-1]])
            hints = [(int(o), s * seg) for s, o in enumerate(offs)]
            block = b"\x00" + put_uvarint(n) + body
            results.append((block, marshal_hints(seg, hints, rng)))
        return results

    def encode_batch_emit(self, blocks, level: int = 2):
        """Fully on-device batched encode: ONE dispatch emits every
        block's token streams (vs the per-block ``encode_emit`` calls the
        r4 writer paid a kernel launch each for)."""
        return self._emit_batch_arrays(blocks, level)

    def encode_batch_mesh(self, mesh, blocks, level: int = 2):
        """Data-parallel batched encode over a device mesh: blocks are
        sharded over the mesh axis, each device runs match-find -> parse ->
        verify -> emit on its shard, and per-block sizes are exchanged with
        an all-gather + exclusive scan (parallel/mesh.py) — the stream
        Writer's production multi-chip path.  Reference concurrency analog:
        writer.go:214-272."""
        return self._emit_batch_arrays(blocks, level, mesh=mesh)

    def encode_batch(self, blocks, level: int = 2):
        """Encode many blocks with one device dispatch.  Returns a list of
        (block, hint_payload) | None entries, aligned with the input."""
        seg = self._seg_for(max(len(b) for b in blocks))
        rng = self._enc.RANGE
        results = self._enc.encode_blocks_device(
            [bytes(b) for b in blocks], seg, rng, level
        )
        out = []
        for block, hints in results:
            if block is None:
                out.append(None)
            else:
                out.append((block, marshal_hints(seg, hints, rng)))
        return out

    def _hinted_segments(self, body: bytes, hint_payload: bytes,
                         decoded_len: int):
        """Validate a block's hints against it; returns (seg_size,
        segments) or raises CorruptError."""
        if decoded_len > MAX_BLOCK_SIZE:
            raise CorruptError("block exceeds maximum block size")
        seg_size, offs, _rng = parse_hints(hint_payload)
        if seg_size % 128 or not 4096 <= seg_size <= (1 << 20):
            raise CorruptError(
                f"unsupported hint segment size {seg_size}"
            )
        if any(b < a for a, b in zip(offs, offs[1:])) or (
            offs and not 0 <= offs[0] <= offs[-1] <= len(body)
        ):
            raise CorruptError("parse-hint offsets out of order")
        return seg_size, split_body(body, offs)

    def decode(self, body: bytes, hint_payload: bytes, decoded_len: int):
        """Decode one hinted block on the device.  Raises CorruptError when
        the hints do not fit the block or the device flags the block."""
        seg_size, segs = self._hinted_segments(body, hint_payload,
                                               decoded_len)
        out = self._exec.decode_blocks([segs], [decoded_len], seg_size)[0]
        if out is None:
            raise CorruptError("device decode found a corrupt block")
        return out

    def decode_batch(self, items):
        """Decode many hinted blocks with one device dispatch per segment
        size (reference DecodeConcurrent, reader.go:575-668 — goroutine
        fan-out replaced by multi-block batching).

        items: list of (body, hint_payload, decoded_len).  Returns a list
        aligned with items: the decoded bytes, or None for a block whose
        hints do not fit it or that the device flagged as corrupt (the
        caller decodes those on the host, which names the error)."""
        out = [None] * len(items)
        groups = {}
        for i, (body, hint_payload, dlen) in enumerate(items):
            try:
                seg_size, segs = self._hinted_segments(body, hint_payload,
                                                       dlen)
            except CorruptError:
                continue
            groups.setdefault(seg_size, []).append((i, segs, dlen))
        for seg_size, entries in groups.items():
            try:
                res = self._exec.decode_blocks(
                    [e[1] for e in entries], [e[2] for e in entries],
                    seg_size,
                )
            except CorruptError:
                continue
            for (i, _, _), r in zip(entries, res):
                out[i] = r
        return out


_codec = None


def get_device_codec():
    global _codec
    if _codec is None:
        _codec = DeviceCodec()
    return _codec
