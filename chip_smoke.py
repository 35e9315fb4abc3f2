#!/usr/bin/env python3
"""Run the MinLZ stream path once on a GPU and check every result.

Usage: python chip_smoke.py [--seed N] [--four-gpus]

Phases (any failure exits non-zero; nothing is caught):

  1. device  - JAX must see GPUs, or the script stops.  Prints platform,
     kind and count, the card's name and power limit, the compile-cache
     directory, and that the native codec loaded.
  2. kernels - at real width: 4 x 1 MiB blocks of the seeded mixed corpus,
     4 KiB segments, 1,024 lanes.  The Triton parse must equal the
     ``lax.scan`` parse on all 7 emission arrays; the XLA executor must
     equal ``decode_kernel.execute_ops_host`` byte for byte on every block,
     and again on one block written with v1 hints.  Prints median times of
     both parses, of the whole decode with each, of the executor, of the
     match finder and of the device emitter.
  3. stream  - a 128 MiB corpus through ``Writer(device=True)`` at level 2
     and back through ``Reader(device=True)``, bit-exact, and through the
     host Reader; the golden Twain block.  Prints GB/s of each direction
     and the Reader's device and host block counts (no host fallbacks
     allowed).

``--four-gpus`` runs only the sharded encode: a 16 MiB prefix through
``Writer(device=True, mesh=<4 cards>)`` must give exactly the bytes of the
one-card ``Writer(device=True, device_emit=True)`` and decode bit-exact.

The last line of output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

MiB = 1 << 20
EMIT_NAMES = ("kind", "dst", "clen", "csrc", "lsrc", "llen", "lacc")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def timed(fn, *args, reps: int = 5, **kw):
    """Median wall time of fn(*args) over ``reps`` calls after one warm-up
    call, each ended by ``block_until_ready``.  Returns (seconds, result)."""
    import jax

    out = jax.block_until_ready(fn(*args, **kw))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def ms(t: float) -> str:
    return f"{t * 1e3:.3f} ms"


# --------------------------------------------------------------------------
# Phase 1: device
# --------------------------------------------------------------------------

def device_info():
    """Fail unless JAX's devices are GPUs; print what runs the program."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX platform is {devs[0].platform!r}; this check runs "
            "only on the card"
        )
    print(f"device: platform={devs[0].platform} kind={devs[0].device_kind} "
          f"count={len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}")
    return devs


def setup_host():
    from minlz_jax.native.codec import get_codec
    from minlz_jax.utils.compile_cache import configure_compile_cache

    print(f"compile cache: {configure_compile_cache()}")
    check(get_codec() is not None, "native codec did not load")
    print("native codec: loaded")


# --------------------------------------------------------------------------
# Phase 2: kernels at real width
# --------------------------------------------------------------------------

def kernel_batch(seed: int, nblocks: int = 4, block: int = MiB):
    """Device-encode ``nblocks`` blocks of the seeded corpus and pack their
    hinted segments for one decode dispatch.  Returns (blocks, segs, seg,
    arrays, statics) with ``arrays``/``statics`` from
    ``executor.plan_batch``."""
    import bench
    from minlz_jax.ops import executor as ex
    from minlz_jax.ops.device_codec import (
        get_device_codec, parse_hints, split_body,
    )
    from minlz_jax.oracle.decode import parse_header

    corpus = bench.make_corpus(nblocks * block, seed)
    blocks = [corpus[i * block:(i + 1) * block] for i in range(nblocks)]
    segs = []
    seg = None
    for b, res in zip(blocks, get_device_codec().encode_batch(blocks, 2)):
        check(res is not None, "a corpus block did not compress")
        blk, hints = res
        seg, offs, _ = parse_hints(hints)
        _, _, pos = parse_header(blk)
        segs.append(split_body(blk[pos:], offs))
    arrays, statics = ex.plan_batch(segs, [len(b) for b in blocks], seg)
    return blocks, segs, seg, arrays, statics


def check_parse(arrays, reps: int = 5):
    """Triton parse vs the lax.scan parse on the packed batch: all 7
    emission arrays equal.  Returns (t_triton, t_scan, emits)."""
    import jax
    import jax.numpy as jnp

    from minlz_jax.ops.decode_kernel import parse_segments_scan
    from minlz_jax.ops.parse_triton import parse_segments_triton

    comp = jnp.asarray(arrays[0]).T  # [n_rows, lanes]
    lens = jnp.asarray(arrays[1])
    scan = jax.jit(lambda c, n: parse_segments_scan(c.astype(jnp.int32), n))
    t_tri, e_tri = timed(parse_segments_triton, comp, lens, reps=reps)
    t_scan, e_scan = timed(scan, comp, lens, reps=reps)
    for name, a, b in zip(EMIT_NAMES, e_tri, e_scan):
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"Triton parse differs from lax.scan in {name}")
    return t_tri, t_scan, e_tri


def host_reference(emits, arrays, nblocks: int):
    """``execute_ops_host`` on each block's lanes of the parse emissions."""
    from minlz_jax.ops.decode_kernel import execute_ops_host

    mat = np.asarray(arrays[0]).T
    lane_len, lane_blk = arrays[4], arrays[5]
    em = [np.asarray(e) for e in emits[:6]]
    out = []
    for b in range(nblocks):
        cols = np.nonzero((lane_blk == b) & (lane_len > 0))[0]
        out.append(b"".join(execute_ops_host(
            *(e[:, cols] for e in em), mat[:, cols], lane_len[cols]
        )))
    return out


def check_executor(blocks, arrays, statics, emits, reps: int = 5):
    """XLA executor vs ``execute_ops_host`` and the original bytes, block
    by block.  Returns (t_exec, rounds)."""
    import jax
    import jax.numpy as jnp

    from minlz_jax.ops import executor as ex

    dev = [jnp.asarray(a) for a in arrays]
    comp = dev[0].T
    run = jax.jit(ex.execute_parsed, static_argnames=("nblk", "block_out"))
    t_exec, (out, bad, rounds) = timed(
        run, emits, comp, *dev[1:], **statics, reps=reps
    )
    out = np.asarray(out)
    check(not np.asarray(bad).any(), "executor flagged a valid block")
    ref = host_reference(emits, arrays, len(blocks))
    for b, blk in enumerate(blocks):
        check(ref[b] == blk, f"execute_ops_host differs on block {b}")
        check(out[b, :len(blk)].tobytes() == ref[b],
              f"executor differs from execute_ops_host on block {b}")
    return t_exec, int(rounds)


def executor_bytes(arrays, statics, rounds: int) -> int:
    """Device-memory bytes the executor moves, from its shapes: the 6
    emission arrays read once, the byte -> record scatter/cummax and five
    per-byte record gathers, then per doubling round one read of the
    pointers, one gathered read and one write, and the final byte gather."""
    lanes, n_rows = arrays[0].shape
    R = lanes * n_rows
    O = statics["nblk"] * statics["block_out"]
    return 6 * 4 * R + 4 * R + O * (3 * 4 + 5 * 4 * 2) + rounds * 12 * O + 2 * O


def v1_payload(seg: int, offs) -> bytes:
    """A parse-hint payload in the v1 layout (no range field)."""
    from minlz_jax.minlz import put_uvarint
    from minlz_jax.ops.device_codec import HINT_MAGIC

    out = bytearray(HINT_MAGIC) + b"\x01" + put_uvarint(seg)
    out += put_uvarint(len(offs))
    prev = 0
    for o in offs:
        out += put_uvarint(o - prev)
        prev = o
    return bytes(out)


def check_v1_block(block: bytes, seg: int = 4096):
    """One block written with v1 hints (no range clamp, copies anywhere in
    the block): the device decode equals ``execute_ops_host`` and the
    block."""
    import jax.numpy as jnp

    from minlz_jax.ops import executor as ex
    from minlz_jax.ops.device_codec import get_device_codec, split_body
    from minlz_jax.ops.encode_kernel import encode_block_device
    from minlz_jax.oracle.decode import parse_header

    blk, hints = encode_block_device(block, seg, 0, 2)
    check(blk is not None, "v1 block did not compress")
    _, _, pos = parse_header(blk)
    offs = [h[0] for h in hints]
    got = get_device_codec().decode(blk[pos:], v1_payload(seg, offs),
                                    len(block))
    arrays, _ = ex.plan_batch([split_body(blk[pos:], offs)], [len(block)],
                              seg)
    emits = ex.parse_records(jnp.asarray(arrays[0]).T,
                             jnp.asarray(arrays[1]))
    ref = host_reference(emits, arrays, 1)[0]
    check(ref == block, "execute_ops_host differs on the v1 block")
    check(got == ref, "device decode differs on the v1 block")


def time_encoder(blocks, seg: int, reps: int = 5):
    """Times of the unchanged encode kernels: the batched match finder over
    all blocks and the device emitter on the first block."""
    import jax
    import jax.numpy as jnp

    from minlz_jax.ops import emit
    from minlz_jax.ops import encode_kernel as ek

    arr = jnp.asarray(np.stack([np.frombuffer(b, np.uint8) for b in blocks]))
    ns = jnp.full((len(blocks),), len(blocks[0]), jnp.int32)
    t_find, _ = timed(ek._find_matches_batch, arr, ns, seg, ek.RANGE, 2,
                      reps=reps)
    one = jax.jit(lambda d, n: emit.encode_block_emit(
        d[None, :].astype(jnp.int32), n, seg, ek.RANGE, 2))
    t_emit, _ = timed(one, arr[0], ns[0], reps=reps)
    return t_find, t_emit


def phase_kernels(seed: int):
    from minlz_jax.ops import executor as ex

    blocks, _, seg, arrays, statics = kernel_batch(seed)
    lanes, n_rows = arrays[0].shape
    nbytes = sum(len(b) for b in blocks)
    print(f"kernels: {len(blocks)} x {len(blocks[0]) >> 10} KiB blocks, "
          f"seg {seg}, {lanes} lanes, {n_rows} rows")
    t_tri, t_scan, emits = check_parse(arrays)
    print(f"parse equal on all 7 emission arrays: triton {ms(t_tri)}, "
          f"lax.scan {ms(t_scan)}")
    t_exec, rounds = check_executor(blocks, arrays, statics, emits)
    moved = executor_bytes(arrays, statics, rounds)
    print(f"executor equal to execute_ops_host on {len(blocks)} blocks: "
          f"{ms(t_exec)}, {rounds} doubling rounds, ~{moved / 1e6:.1f} MB "
          f"moved ({moved / t_exec / 1e9:.1f} GB/s)")
    dev = [np.asarray(a) for a in arrays]
    for parse in ("triton", "scan"):
        t, _ = timed(ex.decode_batch_device, *dev, **statics, parse=parse)
        print(f"whole decode with {parse} parse: {ms(t)} "
              f"({nbytes / t / 1e9:.3f} GB/s, host arrays in)")
    check_v1_block(blocks[0], seg)
    print("v1-hint block: device decode equal to execute_ops_host")
    t_find, t_emit = time_encoder(blocks, seg)
    print(f"match finder (_find_matches_batch, {len(blocks)} blocks): "
          f"{ms(t_find)}; device emitter (1 block): {ms(t_emit)}")


# --------------------------------------------------------------------------
# Phase 3: the stream path
# --------------------------------------------------------------------------

def chunk_counts(stream: bytes) -> dict:
    """Chunk type -> count over a framed stream."""
    counts = {}
    pos = 0
    while pos < len(stream):
        ctype = stream[pos]
        ln = int.from_bytes(stream[pos + 1:pos + 4], "little")
        counts[ctype] = counts.get(ctype, 0) + 1
        pos += 4 + ln
    return counts


def write_stream(data: bytes, **kw) -> tuple[bytes, float]:
    from minlz_jax.stream import Writer

    buf = io.BytesIO()
    t0 = time.perf_counter()
    with Writer(buf, device=True, level=2, **kw) as w:
        w.write(data)
    return buf.getvalue(), time.perf_counter() - t0


def read_stream(enc: bytes, device: bool):
    from minlz_jax.stream import Reader

    t0 = time.perf_counter()
    r = Reader(io.BytesIO(enc), device=device)
    out = r.readall()
    return out, time.perf_counter() - t0, r


def phase_stream(seed: int, corpus_mb: int = 128):
    import bench
    import minlz_jax
    from minlz_jax.minlz import CHUNK_TYPE_PARSE_HINT
    from minlz_jax.ops import executor as ex
    from minlz_jax.oracle.decode import parse_header

    corpus = bench.make_corpus(corpus_mb * MiB, seed)
    # Warm-up on a prefix compiles the batch shapes the full run reuses.
    warm, _ = write_stream(corpus[:16 * MiB])
    read_stream(warm, device=True)

    enc, t_enc = write_stream(corpus)
    print(f"stream encode: {corpus_mb} MiB -> {len(enc)} bytes "
          f"(ratio {len(enc) / len(corpus):.4f}) in {t_enc:.3f} s "
          f"= {len(corpus) / t_enc / 1e9:.3f} GB/s")
    hinted = chunk_counts(enc).get(CHUNK_TYPE_PARSE_HINT, 0)
    for attempt in ("first", "second"):
        out, t_dec, r = read_stream(enc, device=True)
        check(out == corpus, "Reader(device=True) output differs")
        check(r.host_blocks == 0,
              f"{r.host_blocks} blocks fell back to the host")
        check(r.device_blocks == hinted,
              f"{r.device_blocks} device blocks for {hinted} hinted blocks")
        print(f"stream decode ({attempt} pass): bit-exact in {t_dec:.3f} s "
              f"= {len(corpus) / t_dec / 1e9:.3f} GB/s; device blocks "
              f"{r.device_blocks}, host fallbacks {r.host_blocks}")
    out, t_host, _ = read_stream(enc, device=False)
    check(out == corpus, "host Reader output differs")
    print(f"host Reader: bit-exact in {t_host:.3f} s")

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "testdata/Mark.Twain-Tom.Sawyer.txt"),
              "rb") as f:
        twain = f.read()
    with open(os.path.join(here, "testdata/Mark.Twain-Tom.Sawyer.txt.mzb"),
              "rb") as f:
        golden = f.read()
    check(minlz_jax.decode(golden) == twain, "golden block: host decode")
    _, want, pos = parse_header(golden)
    got = ex.decode_blocks([[golden[pos:]]], [want], want)[0]
    check(got == twain, "golden block: device decode")
    print("golden Twain block: bit-exact on host and device")


# --------------------------------------------------------------------------
# --four-gpus: the sharded encode
# --------------------------------------------------------------------------

def phase_four_gpus(seed: int, devs, corpus_mb: int = 16):
    import bench
    from minlz_jax.parallel import make_mesh

    check(len(devs) >= 4, f"--four-gpus needs 4 cards, JAX sees {len(devs)}")
    corpus = bench.make_corpus(corpus_mb * MiB, seed)
    one, t_one = write_stream(corpus, device_emit=True)
    four, t_four = write_stream(corpus, mesh=make_mesh(devs[:4]))
    print(f"one-card emit Writer: {t_one:.3f} s; 4-card mesh Writer: "
          f"{t_four:.3f} s (compile included in both)")
    check(four == one, "mesh stream differs from the one-card emit stream")
    out, t_dec, r = read_stream(four, device=True)
    check(out == corpus, "mesh stream does not decode to the corpus")
    print(f"mesh stream: {len(four)} bytes, identical to one card, decodes "
          f"bit-exact ({r.device_blocks} device blocks, {r.host_blocks} "
          f"host) in {t_dec:.3f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card sharded encode check")
    args = ap.parse_args(argv)

    devs = device_info()
    setup_host()
    if args.four_gpus:
        phase_four_gpus(args.seed, devs)
    else:
        phase_kernels(args.seed)
        phase_stream(args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
