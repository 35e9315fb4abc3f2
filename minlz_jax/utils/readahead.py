"""Asynchronous readahead wrapper for sequential stream consumption.

Analog of the reference CLI's readahead pipe
(reference cmd/internal/readahead): a background thread keeps up to
``buffers`` blocks of ``size`` bytes fetched ahead of the consumer, so
decode never stalls on upstream latency (files over NFS, ranged HTTP).
The wrapper is read-only and strictly sequential — callers needing seeks
use the underlying source directly.
"""

from __future__ import annotations

import queue
import threading


class ReadaheadReader:
    """File-like sequential reader with background prefetch."""

    def __init__(self, src, buffers: int = 4, size: int = 1 << 20):
        self._src = src
        self._q: queue.Queue = queue.Queue(maxsize=max(buffers, 1))
        self._buf = b""
        self._off = 0
        self._eof = False
        self._exc = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._pump, args=(size,), daemon=True
        )
        self._thread.start()

    def _pump(self, size: int) -> None:
        try:
            while not self._closed:
                data = self._src.read(size)
                if not data:
                    break
                self._q.put(data)
        except Exception as exc:  # propagate to the consumer
            self._exc = exc
        finally:
            self._q.put(b"")  # EOF sentinel

    def _fill(self) -> bool:
        """Ensure _buf has unread bytes; False at EOF."""
        while self._off >= len(self._buf):
            if self._eof:
                return False
            data = self._q.get()
            if not data:
                self._eof = True
                if self._exc is not None:
                    raise self._exc
                return False
            self._buf = data
            self._off = 0
        return True

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        if n is None or n < 0:
            while self._fill():
                out += self._buf[self._off :]
                self._off = len(self._buf)
            return bytes(out)
        while n > 0 and self._fill():
            take = min(n, len(self._buf) - self._off)
            out += self._buf[self._off : self._off + take]
            self._off += take
            n -= take
        return bytes(out)

    def close(self) -> None:
        self._closed = True
        # Unblock the pump if it is waiting to put.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
