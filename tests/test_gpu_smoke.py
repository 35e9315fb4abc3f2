"""The device path compiled for the card: every check of ``chip_smoke.py``'s
kernel phase, at a smaller batch.

These tests need a GPU and skip elsewhere.  Run them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_smoke.py``.
"""

import io

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def batch(gpu):
    """Two 256 KiB blocks of the seeded corpus, device-encoded and packed."""
    return cs.kernel_batch(0, nblocks=2, block=256 << 10)


def test_triton_parse_equals_scan(batch):
    _, _, _, arrays, _ = batch
    cs.check_parse(arrays, reps=1)


def test_executor_equals_host_reference(batch):
    blocks, _, _, arrays, statics = batch
    _, _, emits = cs.check_parse(arrays, reps=1)
    _, rounds = cs.check_executor(blocks, arrays, statics, emits, reps=1)
    assert rounds >= 1


def test_v1_hint_block(batch):
    blocks, _, seg, _, _ = batch
    cs.check_v1_block(blocks[0], seg)


def test_encoder_kernels_run(batch):
    blocks, _, seg, _, _ = batch
    t_find, t_emit = cs.time_encoder(blocks, seg, reps=1)
    assert t_find > 0 and t_emit > 0


def test_stream_roundtrip_on_device(gpu, twain):
    """Writer(device=True) -> Reader(device=True) with no host fallback."""
    from minlz_jax.stream import Reader, Writer

    data = twain * 8
    buf = io.BytesIO()
    with Writer(buf, device=True, block_size=64 << 10) as w:
        w.write(data)
    r = Reader(io.BytesIO(buf.getvalue()), device=True)
    assert r.readall() == data
    assert r.host_blocks == 0 and r.device_blocks > 0
