"""The PyTorch port's kernel twins held against the JAX Pallas kernels.

Each CUDA kernel has a plain PyTorch twin (``_kary_body``, ``_rmi_body``,
``_pgm_body``) that its wrapper runs on CPU tensors.  Fed the reference
index's own leaves (``Index.from_numpy``), each twin must give the ranks
of the reference's Pallas kernel in interpret mode and the true ranks,
exactly (integer ranks, no tolerance).  The CUDA kernels themselves are
held against the twins on the card in ``test_torch_gpu.py``.
"""

import jax  # noqa: F401  — both frameworks in one process; data passes as numpy
import numpy as np
import pytest
import torch

from repro import index as rix
from repro.core import true_ranks
from repro_torch import index as tix
from repro_torch import kernels
from repro_torch.core import keys
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.kary_search import _kary_body, kary_search
from repro_torch.kernels.pgm_search import pgm_search
from repro_torch.core.cdf import ceil_log2
from repro_torch.kernels.rmi_search import _rmi_window_body, rmi_search, rmi_search_plain

from conftest import TABLE_KINDS, make_table
from test_torch_build import edge_queries
from test_torch_gpu import clamp_table

#: twin -> the reference spec whose "pallas" backend reaches its TPU kernel
TWIN_SPECS = {
    "kary": lambda n: rix.KOSpec(k=15),
    "rmi": lambda n: rix.RMISpec(b=max(2, min(256, n // 4)), root_type="linear"),
    "pgm": lambda n: rix.PGMSpec(eps=max(4, n // 256)),
}


def _twin_vs_pallas(spec, table, qs):
    ref = rix.build(spec, table)
    leaves = {k: np.asarray(v) for k, v in ref.arrays.items()}
    port = tix.Index.from_numpy(ref.kind, ref.static, leaves, ref.info, device="cpu")
    before = kernels.launches()
    got = port.lookup(table, qs, backend="kernel").numpy()
    assert kernels.launches() == before  # the CPU path runs the twin, launches nothing
    np.testing.assert_array_equal(got, np.asarray(ref.lookup(table, qs, backend="pallas")))
    np.testing.assert_array_equal(got, true_ranks(table, qs))


@pytest.mark.parametrize("table_kind", TABLE_KINDS)
@pytest.mark.parametrize("n", [1000, 65536])
@pytest.mark.parametrize("twin", sorted(TWIN_SPECS))
def test_twin_matches_pallas_interpret(twin, n, table_kind):
    rng = np.random.default_rng(21)
    table = make_table(rng, table_kind, n)
    _twin_vs_pallas(TWIN_SPECS[twin](n), table, edge_queries(rng, table))


@pytest.mark.parametrize("twin", sorted(TWIN_SPECS))
def test_twin_matches_pallas_on_pinned_clamp_table(twin):
    table, qs = clamp_table()
    spec = {"kary": rix.KOSpec(k=15), "rmi": rix.RMISpec(b=64), "pgm": rix.PGMSpec(eps=32)}[twin]
    _twin_vs_pallas(spec, table, qs)


def test_kary_twin_probes_stay_in_range_and_do_not_change_ranks():
    rng = np.random.default_rng(8)
    table = make_table(rng, "lognormal", 5000)
    qs = edge_queries(rng, table)
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    probes = []
    got = _kary_body(q, t, n=len(table), probes=probes)
    np.testing.assert_array_equal(got.numpy(), true_ranks(table, qs))
    np.testing.assert_array_equal(got.numpy(), kary_search(t, q).numpy())
    # 5000 keys: 10 trips down the staged tree leave a window of
    # ceil(5000 / 2^10) = 5 keys, under SWEEP: no global trip, one sweep,
    # whose probes are a binary search's: three trips and the last compare
    assert len(probes) == 14
    assert all(p.numel() == len(qs) for p in probes)
    idx = torch.cat(probes)
    assert int(idx.min()) >= 0 and int(idx.max()) < len(table)


def test_wrappers_validate_operands():
    t = keys.encode(np.arange(1, 65, dtype=np.uint64), "cpu")
    with pytest.raises(TypeError, match="int64"):
        kary_search(t.to(torch.int32), t)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        kary_search(t.reshape(8, 8), t)
    f, i = torch.zeros(2, dtype=torch.float32), torch.zeros(2, dtype=torch.int32)
    one = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="4 elements"):
        rmi_search(t, t, one, one, f, f, f, i, i, i, steps=4)
    with pytest.raises(TypeError, match="float64"):  # kmin/inv_span stay f64: u is the kernel's
        rmi_search(t, t, one.float(), one, torch.zeros(4), f, f, i, i, i, steps=4)
    # the PGM kernel takes the raw queries, f64 kmin/inv_span (u is the
    # kernel's) and the int64 directories as the index holds them
    seg, d = torch.zeros(64), torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="3 elements"):  # off needs levels + 1
        pgm_search(t, t, one, one, t, seg, seg, d, d, d, d, torch.zeros(1, dtype=torch.int32),
                   levels=2, steps=4)
    with pytest.raises(TypeError, match="int64"):  # no int32 copy of a directory
        pgm_search(t, t, one, one, t, seg, seg, d.int(), torch.zeros(3, dtype=torch.int64),
                   torch.zeros(3, dtype=torch.int64), d, torch.zeros(1, dtype=torch.int32),
                   levels=2, steps=4)
    with pytest.raises(TypeError, match="float64"):
        pgm_search(t, t, one.float(), one, t, seg, seg, d, torch.zeros(3, dtype=torch.int64),
                   torch.zeros(3, dtype=torch.int64), d, torch.zeros(1, dtype=torch.int32),
                   levels=2, steps=4)


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.library()


def test_rmi_leaf_product_is_the_reencoders():
    """Regression: with the reference's f32 leaf product ``p * f32(b/n)``,
    keys near a leaf boundary land one leaf past the re-encoder's f64
    assignment, whose fences exclude their rank — on this table the
    reference's Pallas kernel misses 2 of its keys.  The port's kernel and
    twin take the re-encoder's f64 product, so every key is found."""
    from repro_torch.kernels.rmi_search import _rmi_leaf

    rng = np.random.default_rng(0)
    table = make_table(rng, "lognormal", 65536)
    n = len(table)
    idx = tix.build(tix.RMISpec(b=n // 2), table, device="cpu")
    a = idx.to_numpy()
    b = len(a["k_slope"])
    u = np.clip((table.astype(np.float64) - a["kmin"]) * a["inv_span"], 0.0, 1.0).astype(np.float32)
    c = a["k_root"]
    p = ((c[3] * u + c[2]) * u + c[1]) * u + c[0]
    f64_leaf = np.clip(np.floor(p.astype(np.float64) * (b / n)), 0, b - 1)
    f32_leaf = np.clip(np.floor(p * np.float32(b / n)), 0, b - 1)
    assert (f32_leaf != f64_leaf).sum() > 0  # the table exercises the flip
    np.testing.assert_array_equal(_rmi_leaf(torch.from_numpy(p), b=b, n=n).numpy(), f64_leaf)
    np.testing.assert_array_equal(idx.lookup(table, table, backend="kernel").numpy(), np.arange(n))
    # the reference's kernel, on the same leaves, misses keys here
    ref = rix.build(rix.RMISpec(b=n // 2), table)
    assert int((np.asarray(ref.lookup(table, table, backend="pallas")) != np.arange(n)).sum()) == 2


def _early_exit_ranks(table_enc: np.ndarray, qs_enc: np.ndarray, lo, hi, steps: int):
    """The kernel's per-query loop, one query at a time: halve the window
    until it is one key wide (at most ``steps`` trips), then one last
    compare.  Returns the ranks and each query's trip count."""
    ranks, trips = np.empty(len(qs_enc), np.int64), np.empty(len(qs_enc), np.int64)
    for i, q in enumerate(qs_enc):
        base, length, s = int(lo[i]), int(hi[i]) - int(lo[i]) + 1, 0
        while s < steps and length > 1:
            half = length >> 1
            if table_enc[base + half] <= q:
                base += half
            length -= half
            s += 1
        ranks[i] = base + int(table_enc[base] <= q) - 1
        trips[i] = s
    return ranks, trips


@pytest.mark.parametrize("table_kind", TABLE_KINDS)
@pytest.mark.parametrize("kind", ("RMI", "SY-RMI"))
def test_rmi_trips_per_query_fit_under_steps(kind, table_kind):
    """The kernel stops each query's search once its window is one key
    wide, with ``steps`` (bucketed from the widest leaf window) as the cap.
    On every table the widest window needs ``ceil_log2(hi - lo + 1) <=
    steps`` trips, so the cap never cuts a search short, and a per-query
    early-exit loop gives the twin's ranks; the twin's probe list counts
    exactly those trips."""
    rng = np.random.default_rng(23)
    table = make_table(rng, table_kind, 20000)
    qs = edge_queries(rng, table)
    idx = tix.build(kind, table, device="cpu")
    t, q = keys.encode(table, "cpu"), keys.encode(qs, "cpu")
    args, kwargs = tix.impls.query_impl(kind).operands(idx, t, q)
    _, _, kmin, inv_span, root, slope, icept, eps, rlo, rhi = args
    u = keys.unit_f32(q, kmin, inv_span)
    lo, hi = _rmi_window_body(u, root, slope, icept, eps, rlo, rhi, b=slope.numel(), n=len(table))
    steps = kwargs["steps"]
    assert ceil_log2(int((hi - lo + 1).max())) <= steps
    probes = []
    twin = rmi_search_plain(*args, **kwargs, probes=probes).numpy()
    np.testing.assert_array_equal(twin, true_ranks(table, qs))
    ranks, trips = _early_exit_ranks(t.numpy(), q.numpy(), lo.numpy(), hi.numpy(), steps)
    np.testing.assert_array_equal(ranks, twin)
    assert sum(int(p.numel()) for p in probes) == int(trips.sum()) + len(qs)
    assert trips.max() <= steps
