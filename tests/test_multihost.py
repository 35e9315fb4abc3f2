"""Multi-host (DCN) mesh initialization test.

Runs TWO OS processes that join one jax.distributed coordinator (CPU
backend, 4 virtual devices each -> one GLOBAL 8-device mesh spanning both
processes) and drives ``sharded_encode_blocks`` over the global mesh: the
match-find/parse/emit pipeline runs on process-local shards and the
per-block size exchange crosses the process boundary — the multi-host
path claimed in parallel/mesh.py:13-15, exercised for real.

Reference analog: the Writer's cross-goroutine ordered assembly
(reference writer.go:214-272) stretched over a process boundary.
"""

import os
import socket
import subprocess
import sys
import textwrap

_WORKER = textwrap.dedent(
    """
    import os, sys
    pid = int(sys.argv[1]); port = sys.argv[2]
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=4"
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) if "__file__" in dir() else os.getcwd())
    import jax
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental import multihost_utils

    from minlz_jax.parallel import make_mesh
    from minlz_jax.parallel.mesh import sharded_encode_blocks, assemble_blocks
    from minlz_jax.oracle import decode as odec

    mesh = make_mesh()                      # global 8-device mesh, 2 hosts
    seg = 4096
    nblocks = 8                             # one per global device
    N = 8192
    rng = np.random.default_rng(42)
    base = (b"the quick brown fox jumps over the lazy dog. " * 400)[:N]
    blocks_np = np.zeros((nblocks, N), np.int32)
    n_valid_np = np.full((nblocks,), N, np.int32)
    for i in range(nblocks):
        b = bytearray(base)
        for _ in range(8):                  # per-block mutations
            b[int(rng.integers(0, N))] = int(rng.integers(32, 127))
        blocks_np[i] = np.frombuffer(bytes(b), np.uint8)

    # Each process contributes its local half of the global batch.
    blocks_g = multihost_utils.host_local_array_to_global_array(
        blocks_np[pid * 4:(pid + 1) * 4], mesh, P("blocks", None))
    nv_g = multihost_utils.host_local_array_to_global_array(
        n_valid_np[pid * 4:(pid + 1) * 4], mesh, P("blocks"))

    out, lens, sizes, offs = sharded_encode_blocks(
        mesh, blocks_g, nv_g, seg=seg)

    # Collect everything on every process and check the global contract.
    sizes_all = multihost_utils.process_allgather(sizes, tiled=True)
    offs_all = multihost_utils.process_allgather(offs, tiled=True)
    out_all = multihost_utils.process_allgather(out, tiled=True)
    lens_all = multihost_utils.process_allgather(lens, tiled=True)

    expect = np.cumsum(sizes_all) - sizes_all
    assert (offs_all == expect).all(), (offs_all, expect)

    enc = assemble_blocks(out_all, lens_all, n_valid_np, seg=seg)
    for i, e in enumerate(enc):
        assert e is not None
        got = odec.decode_block(e)
        assert got == blocks_np[i].astype(np.uint8).tobytes()
    print(f"MULTIHOST_OK pid={pid}")
    jax.distributed.shutdown()
    """
)


def test_two_process_distributed_encode(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, cwd=str(tmp_path),
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK pid={pid}" in out, out[-4000:]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port
