import os
import sys
import zipfile

# Device tests run on a virtual 8-device CPU mesh so sharding is exercised
# without several cards.  A run that sets JAX_PLATFORMS itself (the
# ``gpu``-marked tests on the card: JAX_PLATFORMS=cuda) keeps its platform.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU; skips elsewhere (run on the card with "
        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_smoke.py)",
    )


@pytest.fixture(scope="session")
def gpu():
    """The GPU devices, or a skip where JAX has none."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {devs[0].platform})")
    return devs


TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata")


@pytest.fixture(scope="session")
def twain() -> bytes:
    with open(os.path.join(TESTDATA, "Mark.Twain-Tom.Sawyer.txt"), "rb") as f:
        return f.read()


@pytest.fixture(scope="session")
def twain_mzb() -> bytes:
    with open(os.path.join(TESTDATA, "Mark.Twain-Tom.Sawyer.txt.mzb"), "rb") as f:
        return f.read()


def load_corpus(zip_name, limit=None):
    """Load raw seed inputs from a go-fuzz style corpus zip."""
    path = os.path.join(TESTDATA, zip_name)
    out = []
    with zipfile.ZipFile(path) as z:
        for name in sorted(z.namelist()):
            if name.endswith("/"):
                continue
            data = z.read(name)
            # go-fuzz corpus files wrap data: `go test fuzz v1\n[]byte(...)`.
            if data.startswith(b"go test fuzz v1"):
                data = _parse_gofuzz(data)
                if data is None:
                    continue
            out.append(data)
            if limit and len(out) >= limit:
                break
    return out


def _parse_gofuzz(data):
    # Single []byte("...") argument with Go escape syntax.
    try:
        line = data.split(b"\n", 1)[1].strip()
        if not line.startswith(b"[]byte("):
            return None
        lit = line[len(b"[]byte(") : -1].strip()
        if lit[:1] in (b'"', b"`"):
            import ast

            return ast.literal_eval(
                "b" + lit.decode("utf-8", "surrogateescape")
            )
    except Exception:
        return None
    return None
