"""The PyTorch port's key encoding, data generators, entry-point device
rules and independence from the JAX package."""

import ast
from pathlib import Path

import jax  # noqa: F401  — both frameworks in one process; data passes as numpy
import numpy as np
import pytest
import torch

from repro.data import distributions as rdist
from repro.data import tables as rtables
from repro_torch import index as tix
from repro_torch.core import keys
from repro_torch.data import distributions as tdist
from repro_torch.data import tables as ttables

ROOT = Path(__file__).resolve().parents[1]
EDGES = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1], dtype=np.uint64)


def test_encode_decode_round_trip_at_the_edges():
    enc = keys.encode(EDGES, "cpu")
    assert enc.dtype == torch.int64
    np.testing.assert_array_equal(keys.decode(enc), EDGES)
    # the encoding keeps the unsigned order under signed compares
    assert enc.tolist() == sorted(enc.tolist())
    assert enc[0].item() == -(2**63) and enc[-1].item() == 2**63 - 1


def test_encoding_preserves_order_and_searchsorted():
    rng = np.random.default_rng(0)
    table = np.unique(np.concatenate([rng.integers(0, 2**64 - 1, 5000, dtype=np.uint64), EDGES]))
    qs = np.concatenate([rng.integers(0, 2**64 - 1, 2000, dtype=np.uint64), EDGES])
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    want = np.searchsorted(table, qs, side="right") - 1
    np.testing.assert_array_equal((torch.searchsorted(t, q, right=True) - 1).numpy(), want)


def test_u64_to_f64_equals_numpy_bit_for_bit():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        EDGES,
        rng.integers(0, 2**64 - 1, 20000, dtype=np.uint64),
        # values that round: odd low bits above 2**53
        (rng.integers(2**53, 2**63, 2000, dtype=np.uint64) | np.uint64(1)),
        np.uint64(2**53) + np.arange(16, dtype=np.uint64),
    ])
    got = keys.to_f64(keys.encode(x, "cpu")).numpy()
    np.testing.assert_array_equal(got.view(np.uint64), x.astype(np.float64).view(np.uint64))


def test_unit_f32_matches_reference_expression():
    rng = np.random.default_rng(2)
    table = np.unique(rng.integers(2**40, 2**62, 3000, dtype=np.uint64))
    qs = np.concatenate([rng.integers(0, 2**64 - 1, 3000, dtype=np.uint64), EDGES])
    kmin = np.float64(table[0])
    inv_span = np.float64(1.0) / np.float64(table[-1] - table[0])
    want = np.clip((qs.astype(np.float64) - kmin) * inv_span, 0.0, 1.0).astype(np.float32)
    got = keys.unit_f32(
        keys.encode(qs, "cpu"), torch.tensor(kmin), torch.tensor(inv_span)
    ).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("name", rdist.DATASETS)
def test_generate_and_make_queries_match_reference(name):
    assert tdist.DATASETS == rdist.DATASETS
    table = tdist.generate(name, 4096, seed=3)
    want = rdist.generate(name, 4096, seed=3)
    assert table.dtype == want.dtype == np.uint64
    np.testing.assert_array_equal(table, want)
    np.testing.assert_array_equal(
        ttables.make_queries(table, 1000, seed=5), rtables.make_queries(want, 1000, seed=5)
    )


@pytest.mark.parametrize("n", (0, 1, 2, 3, 1000, 1 << 16))
def test_sorted_unique_equals_np_unique(n):
    from repro_torch.core.cdf import as_table, sorted_unique

    rng = np.random.default_rng(n)
    for vals in (rng.integers(0, max(n // 3, 1), n).astype(np.uint64),
                 np.concatenate([EDGES, EDGES])[: n + 2], rng.normal(size=n)):
        got = sorted_unique(vals)
        assert got.dtype == vals.dtype
        np.testing.assert_array_equal(got, np.unique(vals))
    np.testing.assert_array_equal(as_table(np.concatenate([EDGES[::-1], EDGES])),
                                  np.unique(EDGES))


def test_tiers_match_reference():
    assert ttables.TIERS == rtables.TIERS


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            roots.add("__import__")
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "__import__"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    table = np.arange(1, 200, dtype=np.uint64) * np.uint64(3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tix.build("PGM", table)
    idx = tix.build("PGM", table, eps=8, device="cpu")
    leaves = idx.to_numpy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tix.Index.from_numpy(idx.kind, idx.static, leaves, idx.info)
    idx.save(tmp_path / "pgm.npz")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tix.Index.load(tmp_path / "pgm.npz")
    # the CPU index answers only because the caller asked for the CPU
    assert idx.device.type == "cpu"
    assert idx.lookup(table, table, backend="kernel").tolist() == list(range(len(table)))


def test_unported_backends_raise():
    """Every backend of the reference is ported now: ``xla`` and ``bbs``
    answer as the reference does; only a name outside ``BACKENDS`` (the
    reference's ``pallas`` is the port's ``kernel``) raises."""
    from repro import index as rix

    table = np.arange(1, 100, dtype=np.uint64) * np.uint64(5)
    qs = np.concatenate([table, table + np.uint64(2), np.array([0, 2**64 - 1], np.uint64)])
    idx = tix.build("L", table, device="cpu")
    ref = rix.build("L", table)
    want = np.searchsorted(table, qs, side="right") - 1
    for backend in ("xla", "bbs"):
        got = idx.lookup(table, qs, backend=backend).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.lookup(table, qs, backend=backend)))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown backend"):
        idx.lookup(table, table, backend="pallas")
