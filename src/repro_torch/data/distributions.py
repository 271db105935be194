"""Synthetic SOSD-style key datasets (counterpart of ``repro.data.distributions``).

Each of the paper's four real datasets is replaced by a generator matched
to its published CDF shape: ``amzn`` (heavy-tailed lognormal, 32 and 64
bit), ``face`` (near-uniform ids with voids), ``osm`` (dense clusters
separated by voids) and ``wiki`` (bursty timestamps).  Same generators,
same seeds, same tables as the reference.
"""

from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core.cdf import as_table

DATASETS = ("amzn32", "amzn64", "face", "osm", "wiki")


def _gen_amzn(rng: np.random.Generator, n: int, bits: int) -> np.ndarray:
    # oversample: dedup of a heavy-tailed integer distribution loses keys
    raw = np.exp(rng.normal(24.0, 3.0, size=int(n * 1.35))).astype(np.uint64)
    scale = np.uint64(2 ** (bits - 1) // max(1, int(raw.max()) or 1))
    return raw * np.maximum(scale, np.uint64(1))


def _gen_face(rng: np.random.Generator, n: int) -> np.ndarray:
    keys = rng.integers(0, 2**63, size=int(n * 1.25), dtype=np.uint64)
    # carve voids: drop ids landing in ~10 random blocks covering ~15%
    for _ in range(10):
        lo = np.uint64(rng.integers(0, 2**63, dtype=np.uint64))
        width = np.uint64(2**63 // 64)
        keys = keys[~((keys >= lo) & (keys < lo + width))]
    return keys


def _gen_osm(rng: np.random.Generator, n: int) -> np.ndarray:
    n_clusters = max(8, n // 2000)
    centers = rng.integers(0, 2**62, size=n_clusters, dtype=np.uint64)
    assign = rng.integers(0, n_clusters, size=int(n * 1.25))
    spread = rng.exponential(2.0**34, size=int(n * 1.25)).astype(np.uint64)
    return centers[assign] + spread


def _gen_wiki(rng: np.random.Generator, n: int) -> np.ndarray:
    base_rate = rng.exponential(1000.0, size=int(n * 1.2))
    burst = (rng.random(int(n * 1.2)) < 0.02).astype(np.float64) * rng.exponential(
        80_000.0, size=int(n * 1.2)
    )
    gaps = (base_rate + burst).astype(np.uint64) + np.uint64(1)
    return np.cumsum(gaps).astype(np.uint64) + np.uint64(1_500_000_000_000)


def generate(name: str, n: int, seed: int = 0) -> np.ndarray:
    """Sorted deduplicated uint64 table of >= n keys, truncated to n.

    The per-dataset seed offset is ``crc32(name)``, which is stable across
    processes (the builtin ``hash`` of a str is salted per process)."""
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (2**31))
    if name == "amzn32":
        keys = _gen_amzn(rng, n, bits=32)
    elif name == "amzn64":
        keys = _gen_amzn(rng, n, bits=64)
    elif name == "face":
        keys = _gen_face(rng, n)
    elif name == "osm":
        keys = _gen_osm(rng, n)
    elif name == "wiki":
        keys = _gen_wiki(rng, n)
    else:
        raise ValueError(f"unknown dataset {name!r}; choose from {DATASETS}")
    table = as_table(keys)
    if len(table) < n:  # top up (rare): re-generate with a new seed
        extra = generate(name, n, seed=seed + 977)
        table = as_table(np.concatenate([table, extra]))
    return table[:n]
