"""Dictionary compression (experimental).

The MinLZ wire format for dictionaries is TBD upstream (SPEC.md §3
"DICTIONARY FORMAT: TBD"; the reference's public dict API is commented out,
dict.go:47-286, while its L2/L3 encoders keep live dict-candidate paths).
This module implements the natural prefix-context semantics those paths
imply: copies may reach back past the block start into the dictionary, the
decoder seeds its window with the dictionary bytes.  Blocks encoded WITHOUT
a dictionary remain fully spec-conformant; dict-encoded blocks require the
same dictionary to decode (no interop claim until the format is specified).

On-device: dictionaries broadcast once to every chip (replicated sharding in
``minlz_jax.parallel``) and concatenate in front of each block's window.
"""

from __future__ import annotations

from .minlz import CorruptError, put_uvarint, read_uvarint
from .oracle import decode as odec
from .oracle import encode as oenc

MIN_DICT_SIZE = 16
MAX_DICT_SIZE = 65536


class Dict:
    """A shared compression dictionary (16B..64KiB)."""

    def __init__(self, data: bytes):
        data = bytes(data)
        if not MIN_DICT_SIZE <= len(data) <= MAX_DICT_SIZE:
            raise ValueError(
                f"dictionary must be {MIN_DICT_SIZE}..{MAX_DICT_SIZE} bytes"
            )
        self._data = data

    @property
    def bytes(self) -> bytes:
        return self._data

    def __len__(self) -> int:
        return len(self._data)

    # --- Serialization (this codec's interim format; upstream TBD) ----------

    def marshal(self) -> bytes:
        return b"MZDICT1" + put_uvarint(len(self._data)) + self._data

    @classmethod
    def load(cls, buf: bytes) -> "Dict":
        if buf[:7] != b"MZDICT1":
            raise CorruptError("bad dictionary magic")
        n, pos = read_uvarint(buf, 7)
        if len(buf) - pos < n:
            raise CorruptError("truncated dictionary")
        return cls(buf[pos : pos + n])


def encode_with_dict(src, d: Dict, level: int = 2,
                     table_bits: int = 16) -> bytes:
    """Encode ``src`` with dictionary context.

    Levels -1..3 run the native optimal-parse encoder with the dictionary
    pre-seeded as match context (reference dict-candidate analog:
    encode_l2.go:607, encode_l3.go:278-296); falls back to the greedy
    Python path if the native codec is unavailable.
    """
    src = bytes(src)
    from .native.codec import get_codec

    codec = get_codec()
    if codec is not None and hasattr(codec._lib, "minlz_encode_block_dict"):
        return codec.encode_block_dict(src, d.bytes, level)
    combined = d.bytes + src
    dst = bytearray(b"\x00" + put_uvarint(len(src)))
    body = _encode_dict_body(combined, len(d), table_bits)
    if body is None or len(body) >= len(src):
        return oenc.encode_uncompressed(src)
    dst += body
    return bytes(dst)


def _encode_dict_body(combined: bytes, dict_len: int, table_bits: int):
    n = len(combined)
    if n - dict_len <= 4:
        return None
    table = [0] * (1 << table_bits)
    # Pre-index the dictionary region.
    for i in range(0, max(dict_len - 3, 0)):
        table[oenc.hash4(int.from_bytes(combined[i : i + 4], "little"),
                         table_bits)] = i

    body = bytearray()
    s = dict_len
    next_emit = dict_len
    s_limit = n - 4
    rep = -1

    def u32(i):
        return int.from_bytes(combined[i : i + 4], "little")

    while s <= s_limit:
        cv = u32(s)
        h = oenc.hash4(cv, table_bits)
        cand = table[h]
        table[h] = s
        if (cand or combined[:4] == combined[s : s + 4]) and cv == u32(cand):
            offset = s - cand
            if 0 < offset <= (2 << 20) + 65535:
                length = 4
                while s + length < n and combined[s + length] == combined[cand + length]:
                    length += 1
                lits = combined[next_emit:s]
                if lits:
                    oenc.emit_literals(body, lits)
                if offset == rep:
                    oenc.emit_repeat(body, length)
                elif offset <= 1024:
                    oenc.emit_copy1(body, offset, length)
                elif offset <= 65599:
                    oenc.emit_copy2(body, offset, length)
                else:
                    oenc.emit_copy3(body, offset, length)
                rep = offset
                s += length
                next_emit = s
                continue
        s += 1
    if next_emit < n:
        oenc.emit_literals(body, combined[next_emit:])
    return body


def decode_with_dict(src, d: Dict) -> bytes:
    """Decode a dict-encoded block: seed the window with the dictionary."""
    src = bytes(src)
    lit_only, want, pos = odec.parse_header(src)
    if lit_only:
        return src[pos:]
    if want == 0:
        return b""
    # Decode with the window seeded by the dictionary.
    return odec.decode_body(src, pos, want, seed=d.bytes)
