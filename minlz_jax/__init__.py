"""minlz_jax: the MinLZ compression format in JAX, with device kernels.

Implements the MinLZ specification v1.0.

Architecture (not a port of the Go reference):
  * ``minlz_jax.minlz``   — format constants, varints, CRC-32C.
  * ``minlz_jax.oracle``  — pure-Python spec oracle (tests' ground truth).
  * ``minlz_jax.block``   — public block API (Encode/Decode, 4 levels).
  * ``minlz_jax.ops``     — JAX/Pallas device kernels (batched blocks).
  * ``minlz_jax.stream``  — framed stream Writer/Reader, seek index.
  * ``minlz_jax.parallel``— multi-device/host sharding of block batches.
  * ``minlz_jax.native``  — C++ host runtime (codec + CRC) via ctypes.
"""

from .minlz import (
    LEVEL_BALANCED,
    LEVEL_FASTEST,
    LEVEL_SMALLEST,
    LEVEL_SUPER_FAST,
    MAX_BLOCK_SIZE,
    CorruptError,
    TooLargeError,
    UnsupportedError,
    max_encoded_len,
)
from .block import (
    append_decoded,
    append_encoded,
    decode,
    decoded_len,
    encode,
    is_minlz,
    try_encode,
)

__version__ = "0.1.0"

__all__ = [
    "encode",
    "decode",
    "try_encode",
    "append_encoded",
    "append_decoded",
    "decoded_len",
    "is_minlz",
    "max_encoded_len",
    "MAX_BLOCK_SIZE",
    "LEVEL_SUPER_FAST",
    "LEVEL_FASTEST",
    "LEVEL_BALANCED",
    "LEVEL_SMALLEST",
    "CorruptError",
    "TooLargeError",
    "UnsupportedError",
]
