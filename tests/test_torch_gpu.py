"""The port's CUDA search kernels held against their plain twins on the card.

Marked ``gpu``: each test decides inside itself (through the ``cuda``
fixture) whether a CUDA device exists and skips with a reason when none
does, so every worker collects the same tests.  This file imports neither
JAX nor the reference: it runs on the machine with the card, which has no
JAX, with ``PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
Ranks are integers and must be equal, with no tolerance.
"""

import numpy as np
import pytest
import torch

from repro_torch import index as tix
from repro_torch import kernels
from repro_torch import tune
from repro_torch.core import as_table, true_ranks

KINDS = ("L", "Q", "C", "KO", "RMI", "SY-RMI", "PGM", "PGM_M", "RS", "BTREE")
KERNEL_OF = {"L": "kary_search", "Q": "kary_search", "C": "kary_search", "KO": "kary_search",
             "RMI": "rmi_search", "SY-RMI": "rmi_search", "PGM": "pgm_search", "PGM_M": "pgm_search",
             "RS": "rs_search", "BTREE": "kary_search"}
#: kinds with a fused batched kernel; the others take the batched model-free search
FUSED_BATCHED = ("RMI", "SY-RMI", "PGM", "PGM_M", "RS")


def _table(rng, kind: str, n: int) -> np.ndarray:
    """The table shapes of ``tests/conftest.py:make_table``."""
    if kind == "uniform":
        return as_table(rng.integers(0, 2**63, size=n, dtype=np.uint64))
    if kind == "lognormal":
        return as_table(np.exp(rng.normal(20, 2, size=n)).astype(np.uint64))
    if kind == "clustered":
        c = rng.integers(0, 2**60, size=max(4, n // 500), dtype=np.uint64)
        return as_table(c[rng.integers(0, len(c), n)] + rng.integers(0, 2**30, n).astype(np.uint64))
    if kind == "bursty":
        g = rng.exponential(100, size=n) * (1 + 50 * (rng.random(n) < 0.01))
        return as_table(np.cumsum(g).astype(np.uint64) + 10**15)
    return as_table(np.arange(n, dtype=np.uint64) * 7 + 3)


def _queries(rng, table):
    keys = rng.choice(table, min(len(table), 2000)).astype(np.uint64)
    with np.errstate(over="ignore"):
        extremes = np.array([0, table.min() - np.uint64(1), table.max() + np.uint64(1), 2**64 - 1],
                            dtype=np.uint64)
    return np.concatenate([keys, keys - np.uint64(1), keys + np.uint64(1),
                           rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64), extremes])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("table_kind", ("uniform", "lognormal", "clustered", "bursty", "sequential"))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_twin_and_ref_on_card(cuda, kind, table_kind):
    rng = np.random.default_rng(31)
    table = _table(rng, table_kind, 65536)
    qs = _queries(rng, table)
    idx = tix.build(kind, table, device=cuda)
    twin = tix.Index.from_numpy(idx.kind, idx.static, idx.to_numpy(), idx.info, device="cpu")
    kernels.reset_launches()
    got = idx.lookup(table, qs, backend="kernel")
    torch.cuda.synchronize()
    assert kernels.launches()[KERNEL_OF[kind]] == 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    np.testing.assert_array_equal(got.cpu().numpy(), twin.lookup(table, qs, backend="kernel").numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), idx.lookup(table, qs, backend="ref").cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), true_ranks(table, qs))


@pytest.mark.gpu
def test_ragged_tail_is_masked(cuda):
    rng = np.random.default_rng(32)
    table = _table(rng, "lognormal", 4096)
    for nq in (1, 255, 257, 1000):
        qs = rng.choice(table, nq)
        for kind in ("KO", "RMI", "PGM", "RS"):
            idx = tix.build(kind, table, device=cuda)
            got = idx.lookup(table, qs, backend="kernel").cpu().numpy()
            np.testing.assert_array_equal(got, true_ranks(table, qs), err_msg=f"{kind}/{nq}")


@pytest.mark.gpu
def test_rmi_leaf_boundary_table_is_exact(cuda):
    """The table on which an f32 leaf product misses keys near leaf
    boundaries (see ``test_rmi_leaf_product_is_the_reencoders``)."""
    rng = np.random.default_rng(0)
    table = _table(rng, "lognormal", 65536)
    idx = tix.build(tix.RMISpec(b=len(table) // 2), table, device=cuda)
    got = idx.lookup(table, table, backend="kernel").cpu().numpy()
    np.testing.assert_array_equal(got, np.arange(len(table)))


def _batched_kernel(kind: str) -> str:
    return "batched_" + (KERNEL_OF[kind] if kind in FUSED_BATCHED else "kary_search")


@pytest.mark.gpu
@pytest.mark.parametrize("ragged", (False, True))
@pytest.mark.parametrize("kind", KINDS)
def test_batched_kernel_matches_twin_and_ref_on_card(cuda, kind, ragged):
    rng = np.random.default_rng(33)
    sizes = (65536, 30000, 50000) if ragged else (65536, 65536, 65536)
    tables = [_table(rng, k, n) for k, n in zip(("uniform", "clustered", "bursty"), sizes)]
    qs = _queries(rng, np.concatenate(tables))
    bm = tune.build_many(kind, tables, device=cuda)
    twin = tune.build_many(kind, tables, device="cpu")
    kernels.reset_launches()
    got = bm.lookup(qs, backend="kernel")
    torch.cuda.synchronize()
    counts = kernels.launches()
    assert counts[_batched_kernel(kind)] == 1
    assert sum(counts.values()) == 1
    assert got.device.type == "cuda" and got.dtype == torch.int64
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got, twin.lookup(qs, backend="kernel").numpy())
    np.testing.assert_array_equal(got, bm.lookup(qs, backend="ref").cpu().numpy())
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(got[i], true_ranks(t, qs), err_msg=f"{kind}/{i}")


@pytest.mark.gpu
def test_batched_ragged_tail_and_row_queries(cuda):
    rng = np.random.default_rng(34)
    tables = [_table(rng, "lognormal", 4096) for _ in range(3)]
    for kind in ("BTREE", "RMI", "PGM", "RS"):
        bm = tune.build_many(kind, tables, device=cuda)
        for nq in (1, 255, 257, 1000):
            rows = np.stack([rng.choice(t, nq) for t in tables])
            got = bm.lookup(rows, backend="kernel").cpu().numpy()
            for i, t in enumerate(tables):
                np.testing.assert_array_equal(got[i], true_ranks(t, rows[i]), err_msg=f"{kind}/{nq}")
