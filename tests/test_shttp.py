"""Seeking HTTP reader + readahead wrapper (reference cmd/internal/shttp
and cmd/internal/readahead analogs)."""

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from minlz_jax.stream import ReadSeeker, Writer
from minlz_jax.utils.readahead import ReadaheadReader
from minlz_jax.utils.shttp import HTTPReaderAt, RangeUnsupportedError


class _RangeHandler(BaseHTTPRequestHandler):
    """Minimal Range-supporting server over one in-memory object."""

    data = b""
    ranges_served = []
    support_ranges = True

    def do_GET(self):  # noqa: N802
        rng = self.headers.get("Range")
        if rng and self.support_ranges:
            spec = rng.split("=", 1)[1]
            lo_s, hi_s = spec.split("-", 1)
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else len(self.data) - 1
            hi = min(hi, len(self.data) - 1)
            body = self.data[lo : hi + 1]
            type(self).ranges_served.append((lo, hi))
            self.send_response(206)
            self.send_header(
                "Content-Range", f"bytes {lo}-{hi}/{len(self.data)}"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_response(200)
            self.send_header("Content-Length", str(len(self.data)))
            self.end_headers()
            self.wfile.write(self.data)

    def log_message(self, *a):  # quiet
        pass


@pytest.fixture()
def http_server():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _RangeHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    _RangeHandler.ranges_served = []
    _RangeHandler.support_ranges = True
    yield srv
    srv.shutdown()


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}/obj"


def test_http_reader_at_random_access(http_server):
    data = bytes(range(256)) * 4000  # 1 MB
    _RangeHandler.data = data
    r = HTTPReaderAt(_url(http_server), chunk=64 << 10)
    assert r.size == len(data)
    r.seek(500_000)
    assert r.read(10) == data[500_000:500_010]
    assert r.read_at(12, 7) == data[12:19]
    # Ranged fetches, not a whole-object download.
    total = sum(hi - lo + 1 for lo, hi in _RangeHandler.ranges_served)
    assert total < len(data) // 2


def test_http_reader_rejects_no_ranges(http_server):
    _RangeHandler.data = b"x" * 1000
    _RangeHandler.support_ranges = False
    with pytest.raises(RangeUnsupportedError):
        HTTPReaderAt(_url(http_server))


def test_seek_decode_over_http_fetches_partially(http_server, twain):
    """mz d -offset over HTTP: the ReadSeeker walk (index probe + block
    fetch) must touch a small fraction of the stream's bytes."""
    payload = twain * 200  # ~2.8 MB uncompressed
    buf = io.BytesIO()
    with Writer(buf, block_size=64 << 10, add_index=True) as w:
        w.encode_buffer(payload)
    enc = buf.getvalue()
    _RangeHandler.data = enc
    r = HTTPReaderAt(_url(http_server), chunk=32 << 10)
    rs = ReadSeeker(r)
    start = len(payload) - 50_000
    rs.seek(start)
    got = rs.read(1000)
    assert got == payload[start : start + 1000]
    fetched = sum(hi - lo + 1 for lo, hi in _RangeHandler.ranges_served)
    assert fetched < len(enc) // 2, (fetched, len(enc))


def test_readahead_reader_matches_plain_read(twain):
    src = io.BytesIO(twain * 37)
    with ReadaheadReader(src, buffers=3, size=4096) as ra:
        out = bytearray()
        while True:
            b = ra.read(1234)
            if not b:
                break
            out += b
    assert bytes(out) == twain * 37


def test_cli_decompress_http_offset(http_server, tmp_path, twain, capsys):
    """End-to-end: the CLI's -offset path over an HTTP URL."""
    from minlz_jax.cli import main as cli_main

    payload = twain * 100
    buf = io.BytesIO()
    with Writer(buf, block_size=32 << 10, add_index=True) as w:
        w.encode_buffer(payload)
    _RangeHandler.data = buf.getvalue()
    out = tmp_path / "out.bin"
    rc = cli_main(
        ["d", "-offset", str(len(payload) - 9000), "-o", str(out),
         _url(http_server)]
    )
    assert rc == 0
    assert out.read_bytes() == payload[-9000:]
    fetched = sum(hi - lo + 1 for lo, hi in _RangeHandler.ranges_served)
    assert fetched < len(_RangeHandler.data) // 2
