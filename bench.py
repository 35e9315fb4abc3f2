"""MinLZ device benchmark: one JSON line of encode + decode throughput.

Measures the device phases on a deterministic Silesia-like mixed corpus,
verifies bit-exact roundtrip, and prints ONE JSON line:

  encode = device match finding (batched) + host parse/serialization
  decode = device transducer parse + executor, one dispatch per batch of
           blocks, over device-resident inputs

Needs a GPU: it prints the device it runs on (platform, kind, count, the
card's name and power limit) and stops without one.  Bit-exact roundtrip of
a corpus prefix through the stream Writer/Reader is checked separately.
Run: python bench.py   (MINLZ_BENCH_MB sizes the corpus; default 8)
"""

import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CORPUS_MB = int(os.environ.get("MINLZ_BENCH_MB", "8"))
ITERS = int(os.environ.get("MINLZ_BENCH_ITERS", "4"))
# MINLZ_PROFILE=<dir>: capture a jax.profiler trace of the device phases
# (the reference CLI's -cpuprof/-traceprof analog; view with tensorboard).
PROFILE_DIR = os.environ.get("MINLZ_PROFILE")


def make_corpus(total_bytes: int, seed: int = 1234) -> bytes:
    """Deterministic mixed corpus (text/json-ish/csv-ish/binary/random),
    roughly Silesia-like in compressibility, made from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "testdata/Mark.Twain-Tom.Sawyer.txt"), "rb") as f:
        twain = f.read()

    parts = []
    size = 0
    i = 0
    words = [w for w in twain.split() if w][:4000]
    while size < total_bytes:
        kind = i % 5
        if kind == 0:  # text with mutations (no trivial global period)
            t = bytearray(twain)
            for _ in range(len(t) // 200):
                t[int(rng.integers(0, len(t)))] = int(rng.integers(32, 127))
            parts.append(bytes(t))
        elif kind == 1:  # json-ish log records
            recs = []
            for k in range(2000):
                recs.append(
                    b'{"ts":%d,"user":"u%d","op":"%s","n":%d}\n'
                    % (
                        1700000000 + i * 1000 + k,
                        int(rng.integers(0, 500)),
                        words[int(rng.integers(0, len(words)))][:12],
                        int(rng.integers(0, 10000)),
                    )
                )
            parts.append(b"".join(recs))
        elif kind == 2:  # csv-ish
            rows = []
            for k in range(3000):
                rows.append(
                    b"%d,%0.2f,%s,%d\n"
                    % (
                        k,
                        float(rng.random() * 100),
                        words[int(rng.integers(0, len(words)))][:10],
                        int(rng.integers(0, 2)),
                    )
                )
            parts.append(b"".join(rows))
        elif kind == 3:  # structured binary (sorted ints, small deltas)
            base = rng.integers(0, 1 << 20, 40000).astype(np.uint32)
            base.sort()
            parts.append(base.tobytes())
        else:  # incompressible
            parts.append(rng.integers(0, 256, 65536, dtype=np.uint8).tobytes())
        size += len(parts[-1])
        i += 1
    return b"".join(parts)[:total_bytes]


def timed_device(fn, args, iters):
    """Median per-call wall time of jitted fn over device-resident args,
    each call ended by ``block_until_ready`` (one warm-up call first)."""
    import jax

    r = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], r


def device_info() -> dict:
    """The device this run measures; exits without a GPU."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX platform is {devs[0].platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    name, power = (x.strip() for x in smi.split(","))
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "name": name, "power_limit": power}


def main():
    import numpy as np

    import jax
    import jax.numpy as jnp

    from minlz_jax.oracle import decode as odec
    from minlz_jax.ops import encode_kernel as ek
    from minlz_jax.ops import executor as ex
    from minlz_jax.ops.device_codec import split_body
    from minlz_jax.stream import Reader, Writer
    from minlz_jax.utils.compile_cache import configure_compile_cache

    device = device_info()
    configure_compile_cache()
    t_start = time.time()
    corpus = make_corpus(CORPUS_MB << 20)
    block_size = 1 << 20
    n_blocks = len(corpus) // block_size
    blocks = [
        corpus[i * block_size : (i + 1) * block_size] for i in range(n_blocks)
    ]

    # ---------------- Encode device phase ---------------------------------
    seg = ek.SEG
    nseg = block_size // seg
    # Ship uint8 once; widen to int32 on device (part of the timed step, as
    # raw bytes are the real input on attached hardware too).
    data_dev = [
        jnp.asarray(np.frombuffer(b, np.uint8))[None, :] for b in blocks
    ]

    # Batched match finding: ENC_BATCH blocks per dispatch (the Writer
    # batches 16 blocks per dispatch).
    enc_batch = min(int(os.environ.get("MINLZ_ENC_BATCH", "4")), n_blocks)
    arr = np.zeros((enc_batch, block_size), np.uint8)
    for i in range(enc_batch):
        arr[i] = np.frombuffer(blocks[i], np.uint8)
    arr_dev = jnp.asarray(arr)
    ns_dev = jnp.full((enc_batch,), block_size, jnp.int32)

    def enc_step(a, ns):
        # rng=RANGE clamps match sources to 128KiB ranges (parse-hints v2),
        # as the stream Writer does.
        return ek._find_matches_batch(a, ns, seg, ek.RANGE, 2)

    import contextlib

    prof = (
        jax.profiler.trace(PROFILE_DIR)
        if PROFILE_DIR
        else contextlib.nullcontext()
    )
    enc_fn = jax.jit(enc_step)
    with prof:
        t_enc_batch, _ = timed_device(enc_fn, (arr_dev, ns_dev), ITERS)
    t_enc_dev = t_enc_batch / enc_batch
    t_enc_dev_total = t_enc_dev * n_blocks

    # ---------------- Encode host phase (parse + serialization) -----------
    # Threaded over the host's cores (the native codec releases the GIL;
    # the reference writer likewise encodes with GOMAXPROCS goroutines,
    # writer.go:214-272) and medianed over repeats.
    from concurrent.futures import ThreadPoolExecutor

    from minlz_jax.native.codec import get_codec

    codec = get_codec()
    dists = []
    for i in range(0, n_blocks, enc_batch):
        chunk = blocks[i : i + enc_batch]
        a = np.zeros((len(chunk), block_size), np.uint8)
        for j, b in enumerate(chunk):
            a[j] = np.frombuffer(b, np.uint8)
        d = np.asarray(
            enc_fn(jnp.asarray(a),
                   jnp.full((len(chunk),), block_size, jnp.int32))
        )
        dists.extend(d[j] for j in range(len(chunk)))

    nthreads = min(os.cpu_count() or 1, 8)
    pool = ThreadPoolExecutor(nthreads)

    def host_pass():
        futs = [
            pool.submit(codec.parse_serialize, b, d, seg, ek.RANGE)
            for b, d in zip(blocks, dists)
        ]
        return [f.result() for f in futs]

    host_times = []
    results = None
    for _ in range(3):
        t0 = time.perf_counter()
        results = host_pass()
        host_times.append(time.perf_counter() - t0)
    host_times.sort()
    t_enc_host = host_times[len(host_times) // 2]
    pool.shutdown()
    blocks_enc = [r[0] for r in results]
    all_hints = [r[1] for r in results]

    comp_total = sum(len(b) for b in blocks_enc)
    ratio = comp_total / len(corpus)

    # Correctness: every encoded block must decode bit-exact (spec oracle).
    from minlz_jax.minlz import put_uvarint

    ok = True
    for b, body in zip(blocks, blocks_enc):
        blk = b"\x00" + put_uvarint(len(b)) + body
        if odec.decode_block(blk) != b:
            ok = False
            break

    # ---------------- Decode device phase ---------------------------------
    # Times the device decode (ops/executor.py) over a BATCH of blocks per
    # dispatch: transducer parse -> record placement -> pointer doubling,
    # one jit over device-resident inputs.
    dec_batch = min(int(os.environ.get("MINLZ_DEC_BATCH", "4")), n_blocks)
    batch_segs = [
        split_body(body, [h[0] for h in hints])
        for body, hints in zip(blocks_enc[:dec_batch], all_hints[:dec_batch])
    ]
    arrays, statics = ex.plan_batch(
        batch_segs, [block_size] * dec_batch, seg
    )
    dev = tuple(jnp.asarray(a) for a in arrays)

    def dec_step(*a):
        return ex.decode_batch_device(*a, **statics)

    t_dec_batch, (out_dev, bad_dev) = timed_device(
        jax.jit(dec_step), dev, ITERS
    )
    t_dec_dev_total = t_dec_batch / dec_batch * n_blocks

    # Decode correctness for every block in the timed batch.
    out_np = np.asarray(out_dev)
    ok = ok and not np.asarray(bad_dev).any()
    for bi in range(dec_batch):
        ok = ok and out_np[bi, :block_size].tobytes() == blocks[bi]

    # ---------------- Stream-layer roundtrip (small, end-to-end) ----------
    small = corpus[: 1 << 20]
    buf = io.BytesIO()
    with Writer(buf, device=True, block_size=256 << 10, add_index=False,
                concurrency=1) as w:
        w.encode_buffer(small)
    ok = ok and Reader(io.BytesIO(buf.getvalue()), device=True).readall() == small

    # ---------------- Report ----------------------------------------------
    n = len(corpus)
    t_enc = t_enc_dev_total + t_enc_host
    t_dec = t_dec_dev_total
    enc_gbps = n / t_enc / 1e9
    dec_gbps = n / t_dec / 1e9
    combined = n / (t_enc + t_dec) / 1e9
    result = {
        "metric": "encode+decode GB/s per device (mixed corpus, device "
                  "phases)",
        "value": round(combined, 4),
        "unit": "GB/s",
        "device": device,
        "encode_gbps": round(enc_gbps, 4),
        "decode_gbps": round(dec_gbps, 4),
        "enc_device_ms_per_mb": round(t_enc_dev * 1000, 2),
        "enc_host_ms_per_mb": round(t_enc_host / n_blocks * 1000, 2),
        "dec_device_ms_per_mb": round(t_dec_batch / dec_batch * 1000, 2),
        "dec_batch": dec_batch,
        "ratio": round(ratio, 4),
        "roundtrip_exact": bool(ok),
        "corpus_mb": CORPUS_MB,
        "total_s": round(time.time() - t_start, 1),
    }
    print(json.dumps(result))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
