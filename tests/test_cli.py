"""CLI end-to-end tests (parity: reference cmd/mz flows)."""

import io
import json
import os
import sys

import pytest

from minlz_jax.cli import main


@pytest.fixture
def workdir(tmp_path, twain, monkeypatch):
    p = tmp_path / "t.txt"
    p.write_bytes(twain * 4)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def run(argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_compress_decompress_roundtrip(workdir, capsys):
    rc, _, _ = run(["c", "t.txt"], capsys)
    assert rc == 0
    assert (workdir / "t.txt.mz").exists()
    rc, out, _ = run(["cat", "t.txt.mz"], capsys)
    assert rc == 0
    # cat writes binary to the real stdout buffer; just check d works:
    rc, _, _ = run(["d", "-o", "out.bin", "t.txt.mz"], capsys)
    assert rc == 0
    assert (workdir / "out.bin").read_bytes() == (workdir / "t.txt").read_bytes()


def test_block_mode_and_levels(workdir, capsys):
    for lvl in ("-xfast", "-2", "-3"):
        rc, _, _ = run(["c", lvl, "-block", "-o", "b.mzb", "t.txt"], capsys)
        assert rc == 0
        rc, _, _ = run(["d", "-o", "b.out", "b.mzb"], capsys)
        assert rc == 0
        assert (workdir / "b.out").read_bytes() == (
            workdir / "t.txt"
        ).read_bytes()


def test_offset_tail_limit(workdir, capsys):
    data = (workdir / "t.txt").read_bytes()
    run(["c", "-bs", "16384", "t.txt"], capsys)
    rc, _, _ = run(
        ["d", "-offset", "20000", "-limit", "100", "-o", "part.bin",
         "t.txt.mz"], capsys)
    assert rc == 0
    assert (workdir / "part.bin").read_bytes() == data[20000:20100]


def test_stats_blocks(workdir, capsys):
    run(["c", "t.txt"], capsys)
    rc, out, _ = run(["stats", "-blocks", "t.txt.mz"], capsys)
    assert rc == 0
    st = json.loads(out)
    assert st["blocks"] >= 1
    assert st["uncompressed"] == os.path.getsize(workdir / "t.txt")
    assert sum(st["op_bytes"].values()) == st["uncompressed"]


def test_search_and_sidecar_cli(workdir, capsys):
    run(["c", "-bs", "16384", "t.txt"], capsys)
    rc, out, _ = run(["s", "Tom Sawyer", "t.txt.mz"], capsys)
    assert rc == 0 and out.count("\n") > 1
    rc, _, _ = run(["sidecar", "build", "t.txt.mz"], capsys)
    assert rc == 0
    rc, out, _ = run(
        ["s", "--sidecar", "t.txt.mz.mzs", "-c", "Tom Sawyer", "t.txt.mz"],
        capsys)
    assert rc == 0
    assert int(out.strip().rsplit(" ", 1)[-1]) > 1


def test_vis_and_block_debug(workdir, capsys):
    run(["c", "-block", "-o", "b.mzb", "t.txt"], capsys)
    rc, _, _ = run(["vis", "b.mzb"], capsys)
    assert rc == 0
    html = (workdir / "b.mzb.html").read_text()
    assert "minlz block" in html
    rc, out, _ = run(["d", "-block-debug", "b.mzb"], capsys)
    assert rc == 0
    assert "lit" in out


def test_glob_expansion(workdir, capsys):
    (workdir / "sub").mkdir()
    (workdir / "sub" / "a.txt").write_bytes(b"hello glob " * 100)
    rc, _, _ = run(["c", "**/*.txt"], capsys)
    assert rc == 0
    assert (workdir / "sub" / "a.txt.mz").exists()


def test_compress_with_search_tables(workdir, capsys):
    rc, _, _ = run(["c", "-search", "-bs", "16384", "t.txt"], capsys)
    assert rc == 0
    raw = (workdir / "t.txt.mz").read_bytes()
    # Search info chunk (0x44) plus at least one table chunk present.
    assert bytes([0x44]) == raw[10:11] or b"\x44" in raw[:64]
    rc, out, _ = run(["s", "-q", "Tom Sawyer", "t.txt.mz"], capsys)
    assert rc == 0


def test_cli_compress_bench_verify(tmp_path, twain, capsys):
    from minlz_jax.cli import main

    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    rc = main(["c", "-bench", "2", "-verify", str(src)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "best of 2" in out and "verified" in out


def test_cli_offset_nl_snapping(tmp_path, twain, capsys):
    from minlz_jax.cli import main

    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    mz = tmp_path / "in.mz"
    assert main(["c", str(src), "-o", str(mz)]) == 0
    out_plain = tmp_path / "o1"
    out_nl = tmp_path / "o2"
    assert main(["d", "-offset", "6000", str(mz), "-o", str(out_plain)]) == 0
    assert main(["d", "-offset", "6000+nl", str(mz), "-o", str(out_nl)]) == 0
    plain = out_plain.read_bytes()
    snapped = out_nl.read_bytes()
    # Snapped output starts exactly after the first newline at/after 6000.
    j = plain.find(b"\n")
    assert snapped == plain[j + 1 :]
    assert twain.endswith(snapped)


def test_cli_compress_cpu_flag(tmp_path, twain):
    from minlz_jax.cli import main

    src = tmp_path / "in.txt"
    src.write_bytes(twain)
    mz = tmp_path / "in.mz"
    assert main(["c", "-cpu", "2", str(src), "-o", str(mz)]) == 0
    out = tmp_path / "out.txt"
    assert main(["d", str(mz), "-o", str(out)]) == 0
    assert out.read_bytes() == twain


def test_stats_dispositions_and_hist(workdir, capsys):
    """mz stats reports block-size histograms always, and per-disposition
    sub-block accounting when 0x46 compressed search tables are present
    (reference mz stats disposition stats, cmd/mz/stats.go)."""
    run(["c", "-search", "-bs", "16384", "t.txt"], capsys)
    rc, out, _ = run(["stats", "t.txt.mz"], capsys)
    assert rc == 0
    st = json.loads(out)
    assert st["block_size_hist"]
    if "search-table-compressed" in st["chunks"]:
        d = st["dispositions"]
        total = sum(
            v["count"] for k, v in d.items() if isinstance(v, dict)
        )
        assert total > 0 and d["bitmap_bytes"] > 0
