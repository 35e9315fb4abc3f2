"""Seeking HTTP reader: random access over HTTP(S) via Range requests.

Analog of the reference CLI's seeking HTTP client
(reference cmd/internal/shttp): ``mz d -offset``/``-tail`` on a URL
must fetch only the byte ranges the seek index walk needs, never the whole
object.  The reader exposes the file-like seek/read surface the stream
layer's ``ReadSeeker`` consumes, with an LRU chunk cache so index probes
near EOF and sequential reads don't re-fetch.
"""

from __future__ import annotations

import io
from collections import OrderedDict
from urllib.request import Request, urlopen


class RangeUnsupportedError(OSError):
    """The server ignored the Range header (no random access)."""


class HTTPReaderAt(io.RawIOBase):
    """Random-access reads over HTTP(S) using Range requests.

    One conditional GET (``Range: bytes=0-0``) discovers the total size
    and verifies range support; after that every cache-missing read costs
    one ranged GET of ``chunk`` bytes.  Raises RangeUnsupportedError when
    the server answers 200 (callers fall back to a full download).
    """

    def __init__(self, url: str, chunk: int = 64 << 10,
                 cache_chunks: int = 64):
        super().__init__()
        self._url = url
        self._chunk = chunk
        self._cache: OrderedDict[int, bytes] = OrderedDict()
        self._cache_max = cache_chunks
        self._pos = 0
        self.fetches = 0  # ranged GETs issued (observability/tests)
        req = Request(url, headers={"Range": "bytes=0-0"})
        with urlopen(req) as r:  # noqa: S310 - explicit user URL
            if r.status == 206:
                cr = r.headers.get("Content-Range", "")
                # "bytes 0-0/12345"
                try:
                    self._size = int(cr.rsplit("/", 1)[1])
                except (IndexError, ValueError) as exc:
                    raise RangeUnsupportedError(
                        f"unparseable Content-Range {cr!r}"
                    ) from exc
                first = r.read()
            else:
                raise RangeUnsupportedError(
                    f"server answered {r.status}, not 206 Partial Content"
                )
        self.fetches += 1
        if first and self._size:
            # Seed the cache's first byte? Not worth special-casing.
            pass

    # --- file-like surface -------------------------------------------------

    @property
    def size(self) -> int:
        return self._size

    def seekable(self) -> bool:
        return True

    def readable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = offset
        elif whence == io.SEEK_CUR:
            self._pos += offset
        elif whence == io.SEEK_END:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def _fetch_chunk(self, ci: int) -> bytes:
        got = self._cache.get(ci)
        if got is not None:
            self._cache.move_to_end(ci)
            return got
        lo = ci * self._chunk
        hi = min(lo + self._chunk, self._size) - 1
        if hi < lo:
            return b""
        req = Request(self._url, headers={"Range": f"bytes={lo}-{hi}"})
        with urlopen(req) as r:  # noqa: S310
            if r.status != 206:
                raise RangeUnsupportedError(
                    f"range GET answered {r.status}"
                )
            data = r.read()
        self.fetches += 1
        self._cache[ci] = data
        while len(self._cache) > self._cache_max:
            self._cache.popitem(last=False)
        return data

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._size - self._pos
        n = max(min(n, self._size - self._pos), 0)
        out = bytearray()
        while n > 0:
            ci, off = divmod(self._pos, self._chunk)
            data = self._fetch_chunk(ci)
            take = min(n, len(data) - off)
            if take <= 0:
                break
            out += data[off : off + take]
            self._pos += take
            n -= take
        return bytes(out)

    def read_at(self, offset: int, n: int) -> bytes:
        """Positional read (ReaderAt surface) — does not move the cursor."""
        save = self._pos
        try:
            self._pos = offset
            return self.read(n)
        finally:
            self._pos = save
