"""Entry-point plumbing: the compile-cache helper, the GPU smoke script's
refusal to run anywhere but on a GPU, and the device Reader's block
accounting."""

import io
import os
import shutil
import subprocess
import sys

import jax
import pytest

from minlz_jax.minlz import CorruptError
from minlz_jax.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    """Restore JAX's cache directory after a test changes it."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_unset_uses_checkout_dir(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_set_is_left_to_jax(monkeypatch, cache_config,
                                          tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def _run_smoke(cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py", "--seed", "0"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    """On the CPU the device check stops the script before any phase, with
    a non-zero exit and no result line."""
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Copied away from the program, the script cannot run."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _device_stream(data, block_size=32 << 10):
    from minlz_jax.stream import Writer

    buf = io.BytesIO()
    with Writer(buf, device=True, block_size=block_size, concurrency=1) as w:
        w.write(data)
    return buf.getvalue()


@pytest.mark.parametrize("batched", [False, True], ids=["readall",
                                                        "concurrent"])
def test_reader_counts_device_blocks(twain, batched):
    from minlz_jax.stream import Reader

    data = (twain * 8)[:96 << 10]
    enc = _device_stream(data)
    r = Reader(io.BytesIO(enc), device=True)
    if batched:
        out = io.BytesIO()
        r.decode_concurrent(out)
        got = out.getvalue()
    else:
        got = r.readall()
    assert got == data
    assert (r.device_blocks, r.host_blocks) == (3, 0)


@pytest.mark.parametrize("batched", [False, True], ids=["readall",
                                                        "concurrent"])
def test_reader_counts_host_fallbacks(twain, monkeypatch, batched):
    """Blocks the device rejects as corrupt decode on the host and are
    counted; the stream still decodes (the host decoder has the final
    word)."""
    from minlz_jax.ops import executor
    from minlz_jax.stream import Reader

    data = (twain * 8)[:96 << 10]
    enc = _device_stream(data)
    monkeypatch.setattr(
        executor, "decode_blocks",
        lambda segs, lens, seg: [None] * len(segs),
    )
    r = Reader(io.BytesIO(enc), device=True)
    if batched:
        out = io.BytesIO()
        r.decode_concurrent(out)
        got = out.getvalue()
    else:
        got = r.readall()
    assert got == data
    assert (r.device_blocks, r.host_blocks) == (0, 3)


@pytest.mark.parametrize("batched", [False, True], ids=["readall",
                                                        "concurrent"])
def test_reader_device_errors_propagate(twain, monkeypatch, batched):
    """A device failure that is not corrupt input is not hidden by a host
    decode."""
    from minlz_jax.ops import executor
    from minlz_jax.stream import Reader

    enc = _device_stream((twain * 8)[:64 << 10])

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(executor, "decode_blocks", boom)
    r = Reader(io.BytesIO(enc), device=True)
    with pytest.raises(RuntimeError, match="device lost"):
        if batched:
            r.decode_concurrent(io.BytesIO())
        else:
            r.readall()


def test_device_codec_raises_on_flagged_block(monkeypatch, twain):
    from minlz_jax.oracle import decode as odec
    from minlz_jax.ops import executor
    from minlz_jax.ops.device_codec import DeviceCodec

    dc = DeviceCodec()
    block, hints = dc.encode((twain * 4)[:40000])
    _, want, pos = odec.parse_header(block)
    monkeypatch.setattr(executor, "decode_blocks",
                        lambda segs, lens, seg: [None])
    with pytest.raises(CorruptError):
        dc.decode(block[pos:], hints, want)
