"""Device (JAX/Pallas) kernels for MinLZ.

Layout convention: a *segment* is the unit of lane parallelism — a span of a
block's output (default 4KiB) that begins at a token boundary.  Our encoder
emits segment parse hints (chunk 0x88) so decode can run all segments of a
block in lockstep lanes; foreign (hint-less) streams fall back to the host
codec.

Kernels:
  transducer    — the byte-lockstep parse step (one byte per step, all lanes
      advance together; divergence lives in state space, not address space).
  decode_kernel — plain references: lax.scan parse + host span executor.
  parse_triton  — the parse as one Pallas kernel through Triton (GPU).
  executor      — device decode: parse + XLA record executor (pointer
      doubling), one dispatch per batch of blocks.
  encode_kernel — batched-sort candidate finder + lockstep greedy parse +
      scalar serializer.
  emit          — on-device token emission (host-free encode).
"""

from .decode_kernel import decode_segments_jnp

__all__ = ["decode_segments_jnp"]
