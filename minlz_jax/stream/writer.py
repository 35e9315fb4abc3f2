"""Framed stream writer — parity surface with reference ``writer.go``.

The reference parallelizes with per-block goroutines ordered by a channel of
channels (writer.go:214-272).  Here the equivalent is batch-oriented: whole
blocks are handed to an encoder backend that may batch many blocks per device
dispatch (``minlz_jax.ops``) or fan out across host threads (native codec
releases the GIL), and results are written in submission order.
"""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor

from .. import block as blockapi
from ..minlz import (
    CHUNK_TYPE_EOF,
    CHUNK_TYPE_MINLZ_COMPRESSED,
    CHUNK_TYPE_MINLZ_COMPRESSED_CRC,
    CHUNK_TYPE_PADDING,
    CHUNK_TYPE_UNCOMPRESSED_DATA,
    DEFAULT_BLOCK_SIZE,
    LEVEL_BALANCED,
    MAGIC_CHUNK,
    MAX_BLOCK_SIZE,
    MIN_BLOCK_SIZE,
    crc,
    put_uvarint,
)
from .index import Index


def _block_size_log(block_size: int) -> int:
    log = block_size.bit_length() - 1
    if 1 << log != block_size:
        log += 1
    return log


class Writer:
    """Streaming MinLZ writer.

    Options mirror the reference's ``WriterOption`` set:
      block_size     — 4KiB..8MiB, rounded up to a power of two in the header.
      level          — LEVEL_SUPER_FAST..LEVEL_SMALLEST, or 0 for uncompressed.
      add_index      — append a seek index before EOF on close().
      padding        — pad final stream to a multiple of this size.
      concurrency    — number of encoder threads (host path).
      flush_on_write — flush after every write() call.
      custom_encoder — callable(src: bytes, level: int) -> bytes | None
                       (reference WriterCustomEncoder); None output falls back.
      uncompressed   — always emit uncompressed chunks (reference
                       WriterUncompressed).
      index_returned_on_close — if CloseIndex-style retrieval is wanted, use
                       close(return_index=True).
    """

    def __init__(
        self,
        dst,
        *,
        block_size: int = DEFAULT_BLOCK_SIZE,
        level: int = LEVEL_BALANCED,
        add_index: bool = True,
        padding: int = 0,
        concurrency: int | None = None,
        flush_on_write: bool = False,
        custom_encoder=None,
        uncompressed: bool = False,
        encoder_backend=None,
        device: bool = False,
        device_emit: bool = False,
        mesh=None,
        parse_hints: bool | None = None,
        search_table=None,
        sidecar=None,
        padding_src=None,
        debug_validate: bool = False,
    ):
        if not MIN_BLOCK_SIZE <= block_size <= MAX_BLOCK_SIZE:
            raise ValueError(f"block_size {block_size} out of range 4KiB..8MiB")
        if device and block_size == DEFAULT_BLOCK_SIZE:
            # Device geometry: 1MiB blocks give 256 segment lanes each, and
            # a decode batch of them fills the parse grid; explicit
            # block_size choices are honored as-is.
            block_size = 1 << 20
        if padding < 0 or padding > (4 << 20):
            raise ValueError("padding must be 0..4MiB")
        self._dst = dst
        self._block_size = block_size
        self._level = level
        self._add_index = add_index
        self._padding = padding
        self._flush_on_write = flush_on_write
        self._custom_encoder = custom_encoder
        self._uncompressed_only = uncompressed
        self._backend = encoder_backend
        self._device = device
        # device_emit: serialize tokens ON DEVICE too (DeviceCodec.
        # encode_emit) — no host serializer in the loop, at a ratio cost;
        # for host-CPU-free pipelines.
        self._device_emit = device_emit
        # mesh: a jax.sharding.Mesh — block batches are sharded data-
        # parallel over its first axis (parallel/mesh.py collective
        # pipeline; the reference Writer's goroutine concurrency,
        # writer.go:214-272, as a device mesh).  Implies device emission.
        if mesh is not None and not device:
            raise ValueError("mesh= requires device=True")
        self._mesh = mesh
        self._parse_hints = device if parse_hints is None else parse_hints
        self._search_cfg = search_table
        self._search_held = None  # raw block deferred for overlap indexing
        self._wrote_search_info = False
        # Sidecar diversion (reference WriterSidecar/SetSidecar,
        # writer.go:1409): search chunks go to this file-like object plus a
        # remote block reference (0x47) per block; the main stream carries
        # only data.
        self._sidecar = sidecar
        self._sidecar_started = False
        self._padding_src = padding_src
        self._last_data_off = 0  # main-stream offset of last data chunk
        # Decode every block right after encoding it and compare
        # (reference debugValidateBlocks, encode.go:108).
        self._debug_validate = debug_validate
        if device:
            from ..ops.device_codec import get_device_codec

            self._device_codec = get_device_codec()
        else:
            self._device_codec = None
        # Device blocks are encoded in batches of this many per dispatch
        # (amortizes per-dispatch cost; blocks stay in submission order).
        # 16 x 2MiB blocks = 32MiB of match-finder working set per dispatch.
        self._dev_batch = []
        self._dev_batch_size = 16
        if concurrency is None:
            concurrency = min(os.cpu_count() or 1, 8)
        self._concurrency = max(1, concurrency)
        self._pool = (
            ThreadPoolExecutor(self._concurrency)
            if self._concurrency > 1
            else None
        )
        self._pending = []  # ordered futures / results
        self._buf = bytearray()
        self._index = Index() if add_index else None
        self._written_in = 0  # uncompressed bytes accepted
        self._written_out = 0  # compressed bytes emitted
        self._wrote_header = False
        self._closed = False
        self._err = None

    # --- Public API ---------------------------------------------------------

    def write(self, data) -> int:
        """Buffer ``data``; complete blocks are compressed and emitted."""
        self._check_open()
        self._buf += data
        while len(self._buf) >= self._block_size:
            chunk = bytes(self._buf[: self._block_size])
            del self._buf[: self._block_size]
            self._submit_block(chunk)
        if self._flush_on_write:
            self.flush()
        return len(data)

    def read_from(self, src) -> int:
        """Stream directly from a file-like object (reference ReadFrom)."""
        self._check_open()
        total = 0
        while True:
            data = src.read(self._block_size)
            if not data:
                break
            total += len(data)
            self.write(data)
        return total

    def encode_buffer(self, data) -> None:
        """Zero-copy-ish path for a large contiguous buffer (reference
        EncodeBuffer, writer.go:441): submits every full block without
        intermediate buffering."""
        self._check_open()
        data = memoryview(data)
        if self._buf:
            # Mixed use: fall back to the buffering path.
            self.write(data)
            return
        pos = 0
        n = len(data)
        while n - pos >= self._block_size:
            self._submit_block(bytes(data[pos : pos + self._block_size]))
            pos += self._block_size
        self._buf += data[pos:]

    def write_preencoded(self, block: bytes, data_len: int) -> None:
        """Emit an already-encoded MinLZ block (leading 0x00 marker) as one
        stream chunk.  Uses the compressed-CRC chunk type 0x03 since the
        uncompressed bytes are not available (LZ4 conversion path).

        ``data_len`` is the block's decoded size; it must not exceed the
        stream's block size."""
        self._check_open()
        if data_len > self._block_size:
            raise ValueError(
                f"pre-encoded block decodes to {data_len} bytes,"
                f" above the stream block size {self._block_size}"
            )
        if block[:1] != b"\x00":
            raise ValueError("not a MinLZ block (missing 0x00 marker)")
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._submit_block(chunk)
        self._drain()
        self._ensure_header()
        body = block[1:]
        payload = crc(body).to_bytes(4, "little") + body
        if self._index is not None:
            self._index.add(self._written_out, self._written_in)
        self._written_in += data_len
        chunk = (
            bytes([CHUNK_TYPE_MINLZ_COMPRESSED_CRC])
            + len(payload).to_bytes(3, "little")
            + payload
        )
        self._write_out(chunk)

    def async_flush(self) -> None:
        """Hand all buffered data to the encoders without waiting for the
        writes to land (reference AsyncFlush, writer.go:969)."""
        self._check_open()
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._submit_block(chunk)

    def add_user_chunk(self, chunk_id: int, data=b"") -> None:
        """Emit a user chunk (0x80-0xfd).  Reference AddUserChunk."""
        self._check_open()
        if not 0x80 <= chunk_id <= 0xFD:
            raise ValueError("user chunk id must be 0x80..0xfd")
        if len(data) > (16 << 20):
            raise ValueError("user chunk larger than 16MB")
        self._drain()
        self._emit_raw_chunk(chunk_id, bytes(data))

    def flush(self, _final: bool = False) -> None:
        """Compress and emit all buffered data (partial block included).

        A mid-stream flush emits any overlap-deferred block WITHOUT a search
        table (SPEC_SEARCH.md B.1); on close the final block keeps its table.
        """
        self._check_open()
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self._submit_block(chunk)
        if self._search_held is not None:
            held = self._search_held
            self._search_held = None
            self._emit_search_block(held, b"", with_table=_final)
        self._drain()
        if hasattr(self._dst, "flush"):
            self._dst.flush()

    def close(self, return_index: bool = False):
        """Flush, then emit EOF (+ optional index and padding) and close.

        With return_index=True the index is returned instead of being
        appended (reference CloseIndex)."""
        if self._closed:
            return None
        self.flush(_final=True)
        idx = self._index
        # EOF chunk with total uncompressed size.
        eof_payload = put_uvarint(self._written_in)
        self._emit_raw_chunk(CHUNK_TYPE_EOF, eof_payload)
        if idx is not None:
            idx.total_uncompressed = self._written_in
            idx.total_compressed = self._written_out
        # Reference closeIndex ordering (writer.go:1085-1126): the index
        # bytes are built BEFORE padding (with total_compressed = -1 when
        # padding will follow, since the padded size is not yet known), the
        # index length is counted toward the padding target, padding is
        # emitted, and the index chunk goes LAST so Index.load_stream finds
        # its trailer at EOF.
        index_bytes = b""
        if self._add_index and not return_index and idx is not None and idx.info:
            idx.est_block_uncomp = self._block_size
            idx.total_compressed = -1 if self._padding > 1 else self._written_out
            index_bytes = idx.marshal()
        if self._padding > 1:
            self._emit_padding(extra=len(index_bytes))
        if index_bytes:
            self._write_out(index_bytes)
        if self._sidecar is not None and self._sidecar_started:
            self._sidecar.write(bytes([CHUNK_TYPE_EOF, 0, 0, 0]))
        self._closed = True
        if self._pool:
            self._pool.shutdown(wait=False)
        return idx if return_index else None

    def written(self):
        """(uncompressed_in, compressed_out) byte counters."""
        return self._written_in, self._written_out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- Internals ----------------------------------------------------------

    def _check_open(self):
        if self._closed:
            raise ValueError("writer is closed")
        if self._err:
            raise self._err

    def _ensure_header(self):
        if not self._wrote_header:
            self._wrote_header = True
            # [0xff][len=6 LE24]["MinLz"][block size indicator] (SPEC.md §4.1)
            size_ind = _block_size_log(self._block_size) - 10
            self._write_out(MAGIC_CHUNK + bytes([size_ind]))

    def _submit_block(self, data: bytes):
        self._ensure_header()
        if self._search_cfg is not None:
            # Defer one block so its table can index boundary overlaps
            # (SPEC_SEARCH.md B.1).
            if not self._wrote_search_info:
                self._wrote_search_info = True
                info = self._search_cfg.marshal_info(self._block_size)
                if self._sidecar is not None:
                    if not self._sidecar_started:
                        self._sidecar_started = True
                        size_ind = _block_size_log(self._block_size) - 10
                        self._sidecar.write(
                            MAGIC_CHUNK + bytes([size_ind])
                        )
                    self._sidecar.write(info)
                else:
                    self._drain()
                    self._write_out(info)
            held = self._search_held
            self._search_held = data
            if held is None:
                return
            cfg = self._search_cfg
            need = (
                len(cfg.prefixes) - 1 + cfg.match_len + cfg.extra_matches
                if cfg.table_type == 4
                else cfg.match_len
            )
            self._emit_search_block(held, data[:need])
            return
        self._submit_block_inner(data)

    def _emit_search_block(self, data: bytes, overlap: bytes,
                           with_table: bool = True):
        from ..search.build import build_table_auto

        table_chunk = None
        if with_table:
            res = build_table_auto(
                data, self._search_cfg, overlap, self._block_size
            )
            if res is not None:
                table, reductions = res
                table_chunk = self._search_cfg.marshal_table(
                    self._block_size, table, reductions
                )
        if self._sidecar is None:
            if table_chunk is not None:
                self._drain()
                self._write_out(table_chunk)
            self._submit_block_inner(data)
            self._drain()
            return
        # Sidecar mode: table + remote block ref go to the sidecar; the
        # main stream gets only the data chunk.
        if table_chunk is not None:
            self._sidecar.write(table_chunk)
        self._submit_block_inner(data)
        self._drain()
        from ..minlz import CHUNK_TYPE_REMOTE_BLOCK_REF

        payload = put_uvarint(self._last_data_off) + put_uvarint(
            max(self._block_size - len(data), 0)
        )
        self._sidecar.write(
            bytes([CHUNK_TYPE_REMOTE_BLOCK_REF])
            + len(payload).to_bytes(3, "little")
            + payload
        )

    def _submit_block_inner(self, data: bytes):
        uoff = self._written_in
        self._written_in += len(data)
        if (
            self._device_codec is not None
            and self._custom_encoder is None
            and not self._uncompressed_only
        ):
            self._dev_batch.append((data, uoff))
            if len(self._dev_batch) >= self._dev_batch_size:
                self._flush_dev_batch()
            return
        if self._pool is not None and self._backend is None:
            fut = self._pool.submit(self._encode_one, data)
            self._pending.append((fut, len(data), uoff))
            # Bound memory: keep at most 2x concurrency blocks in flight.
            while len(self._pending) > 2 * self._concurrency:
                self._drain_one()
        else:
            self._pending.append((self._encode_one(data), len(data), uoff))
            self._drain_one()

    def _encode_one(self, data: bytes):
        """Compress one block; returns the full chunk bytes (header+payload),
        preceded by a parse-hint chunk (0x88) on the device path."""
        hint_chunk = b""
        if self._uncompressed_only:
            comp = None
        else:
            comp = None
            if self._custom_encoder is not None:
                comp = self._custom_encoder(data, self._level)
                if comp is not None and comp[:1] == b"\x00":
                    comp = comp[1:]
            if comp is None and self._device_codec is not None:
                if self._device_emit:
                    res = self._device_codec.encode_emit(data, self._level)
                else:
                    res = self._device_codec.encode(data, self._level)
                if res is not None:
                    block, hint_payload = res
                    comp = block[1:]  # strip the 0x00 MinLZ marker
                    if self._parse_hints:
                        from ..minlz import CHUNK_TYPE_PARSE_HINT

                        hint_chunk = (
                            bytes([CHUNK_TYPE_PARSE_HINT])
                            + len(hint_payload).to_bytes(3, "little")
                            + hint_payload
                        )
            if comp is None and self._device_codec is None:
                comp = blockapi.encode(data, self._level)
                # Strip the leading 0x00 marker: stream chunks store the block
                # without the MinLZ indicator byte (SPEC.md §4.4).
                comp = comp[1:]
            if comp is not None and len(comp) >= len(data):
                comp = None
                hint_chunk = b""
        if comp is not None and self._debug_validate:
            if blockapi.decode(b"\x00" + comp) != data:
                raise AssertionError(
                    "debug_validate: encoded block does not decode to input"
                )
        c = crc(data)
        if comp is None:
            payload = c.to_bytes(4, "little") + data
            ctype = CHUNK_TYPE_UNCOMPRESSED_DATA
        else:
            payload = c.to_bytes(4, "little") + comp
            ctype = CHUNK_TYPE_MINLZ_COMPRESSED
        chunk = bytes([ctype]) + len(payload).to_bytes(3, "little") + payload
        return hint_chunk + chunk

    def _latch(self, exc):
        """First-error latching (reference Writer.err, writer.go:168-179):
        remember the first failure, drop queued work so state stays
        consistent, and re-raise.  Every subsequent API call re-raises the
        latched error via _check_open."""
        if self._err is None:
            self._err = exc
        # Cancel/drop in-flight work; the stream is no longer valid.
        for item, _, _ in self._pending:
            if hasattr(item, "cancel"):
                item.cancel()
        self._pending.clear()
        self._dev_batch.clear()
        raise exc

    def _drain_one(self):
        if not self._pending:
            return
        item, usize, uoff = self._pending.pop(0)
        try:
            chunk = item.result() if hasattr(item, "result") else item
        except Exception as exc:  # encoder failure → sticky error
            self._latch(exc)
        if self._index is not None:
            self._index.add(self._written_out, uoff)
        # Offset of the data chunk itself (skipping a parse-hint prefix).
        self._last_data_off = self._written_out
        from ..minlz import CHUNK_TYPE_PARSE_HINT

        if chunk[:1] == bytes([CHUNK_TYPE_PARSE_HINT]):
            self._last_data_off += 4 + int.from_bytes(chunk[1:4], "little")
        self._write_out(chunk)

    def _flush_dev_batch(self):
        if not self._dev_batch:
            return
        batch = self._dev_batch
        self._dev_batch = []
        try:
            if self._mesh is not None:
                results = self._device_codec.encode_batch_mesh(
                    self._mesh, [d for d, _ in batch], self._level
                )
            elif self._device_emit:
                # One dispatch for the whole batch (the r4 writer paid a
                # kernel launch per block here).
                results = self._device_codec.encode_batch_emit(
                    [d for d, _ in batch], self._level
                )
            else:
                results = self._device_codec.encode_batch(
                    [d for d, _ in batch], self._level
                )
        except Exception as exc:  # device failure → sticky error
            self._latch(exc)
        from ..minlz import CHUNK_TYPE_PARSE_HINT

        for (data, uoff), res in zip(batch, results):
            c = crc(data)
            if res is None:
                payload = c.to_bytes(4, "little") + data
                ctype = CHUNK_TYPE_UNCOMPRESSED_DATA
                hint_chunk = b""
            else:
                block, hint_payload = res
                comp = block[1:]  # strip the 0x00 MinLZ marker
                if len(comp) >= len(data):
                    payload = c.to_bytes(4, "little") + data
                    ctype = CHUNK_TYPE_UNCOMPRESSED_DATA
                    hint_chunk = b""
                else:
                    payload = c.to_bytes(4, "little") + comp
                    ctype = CHUNK_TYPE_MINLZ_COMPRESSED
                    hint_chunk = b""
                    if self._parse_hints:
                        hint_chunk = (
                            bytes([CHUNK_TYPE_PARSE_HINT])
                            + len(hint_payload).to_bytes(3, "little")
                            + hint_payload
                        )
            if self._index is not None:
                self._index.add(self._written_out, uoff)
            self._last_data_off = self._written_out + len(hint_chunk)
            self._write_out(
                hint_chunk
                + bytes([ctype])
                + len(payload).to_bytes(3, "little")
                + payload
            )

    def _drain(self):
        self._flush_dev_batch()
        while self._pending:
            self._drain_one()

    def _emit_raw_chunk(self, chunk_id: int, payload: bytes):
        self._ensure_header()
        chunk = bytes([chunk_id]) + len(payload).to_bytes(3, "little") + payload
        self._write_out(chunk)

    def _emit_padding(self, extra: int = 0):
        # Pad stream to a multiple of self._padding (reference
        # calcSkippableFrame, writer.go:1135).  ``extra`` counts bytes that
        # will be appended after the padding (the trailing index chunk) so
        # the final file size is the aligned one.
        pad = (-(self._written_out + extra)) % self._padding
        if pad == 0:
            return
        if pad < 4:
            pad += self._padding
        if self._padding_src is not None:
            # Reference WriterPaddingSrc: caller supplies padding bytes
            # (e.g. random, to obscure compressed sizes).
            payload = bytes(self._padding_src(pad - 4))[: pad - 4]
            payload += bytes(pad - 4 - len(payload))
        else:
            payload = bytes(pad - 4)
        self._emit_raw_chunk(CHUNK_TYPE_PADDING, payload)

    def _write_out(self, data: bytes):
        self._dst.write(data)
        self._written_out += len(data)


def compress(data, **opts) -> bytes:
    """One-shot stream compression convenience."""
    buf = io.BytesIO()
    with Writer(buf, **opts) as w:
        w.encode_buffer(data)
    return buf.getvalue()
