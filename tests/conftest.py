"""Test configuration: run JAX on CPU with 8 virtual devices.

Multi-device sharding is validated on a virtual CPU mesh (the reference
has no automated tests at all — SURVEY.md section 4; we add the suite
it lacked). The GPU path is proven by ``python chip_smoke.py`` on a
machine with the card; tests marked ``gpu`` skip where there is none.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# CPU unless the caller names a platform (the card's tests run with
# JAX_PLATFORMS=cuda python -m pytest -m gpu tests/)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest

from soap3dp_tpu.index.packing import PackedGenome
from soap3dp_tpu.utils import dna


def make_genome(rng: np.random.Generator, length: int, num_chrom: int = 1,
                n_run: tuple[int, int] | None = None) -> PackedGenome:
    """Synthetic random genome, optionally with an N-run (ambiguity region)."""
    codes = rng.integers(0, 4, size=length).astype(np.uint8)
    raw = np.frombuffer(dna.decode(codes), dtype=np.uint8).copy()
    if n_run is not None:
        s, l = n_run
        raw[s:s + l] = ord("N")
    bounds = np.linspace(0, length, num_chrom + 1).astype(int)
    names = [f"chr{i + 1}" for i in range(num_chrom)]
    arr = raw
    chunks = [arr[bounds[i]:bounds[i + 1]] for i in range(num_chrom)]
    codes = dna.CHAR_TO_CODE[arr]
    valid = dna.IS_ACGT[arr]
    from soap3dp_tpu.index.packing import _runs_of
    amb_starts, amb_lengths = _runs_of(~valid)
    return PackedGenome(
        codes=codes,
        pac=dna.pack_codes(codes),
        length=length,
        names=names,
        offsets=np.asarray(bounds, dtype=np.uint64),
        amb_starts=amb_starts,
        amb_lengths=amb_lengths,
    )


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture(scope="session")
def small_genome(rng):
    return make_genome(rng, 20_000)


@pytest.fixture(scope="session")
def small_index(small_genome):
    from soap3dp_tpu.index.builder import build_index
    return build_index(small_genome, sa_rate=8)


@pytest.fixture(scope="session")
def small_device_index(small_index):
    from soap3dp_tpu.fm.fmindex import device_index
    return device_index(small_index)
