"""The port's device fits held against the JAX reference: the corridor
scans (exact and fast) of PGM and RadixSpline, the device helpers of
``core.cdf``, PGM's device slopes and verified ε, RadixSpline's chord
re-measure, the RMI leaf fit, the device re-encoders, the tier's device
pad, ``build_many(fit="vmap"/"fast"/"auto")``, ``build_grid``,
``device_refresh`` and the CDF-preserving subsample.

The same seeded numpy inputs go through both packages: the five table
shapes of ``conftest.make_table`` (resampled to one length, so a jitted
reference compiles once), the pinned clustered table, tables of 1-3 keys
and ``_COLLIDING`` (adjacent keys at 2^60, which collide in f64: the fast
fits must refuse them).  On the CPU the kernel wrappers run their twins
(:func:`repro_torch.kernels.corridor_scan.corridor_scan_twin`, and
``corridor_scan_exact_twin`` for the exact scans).  Masks,
ranks, keys and counts are integers or bools: equal, no tolerance.  The
RMI leaf floats are held to rtol 1e-12 (sums in another order could move
them by a few ulp; on the CPU they come out equal), ε to ±1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import index as rix
from repro import tune as rtune
from repro.core import cdf as rcdf
from repro.core import pgm as rpgm
from repro.core import radix_spline as rrs
from repro.core import rmi as rrmi
from repro.core.cdf import true_ranks
from repro.data import distributions
from repro.data import tables as rtables
from repro.dist import sharded_index as rsi
from repro.tune import device_fit as rdf
from repro_torch import index as tix
from repro_torch import kernels
from repro_torch import tune as ttune
from repro_torch.core import cdf as tcdf
from repro_torch.core import keys
from repro_torch.core import pgm as tpgm
from repro_torch.core import radix_spline as trs
from repro_torch.core import rmi as trmi
from repro_torch.data import tables as ttables
from repro_torch.dist import sharded_index as tsi
from repro_torch.kernels import ops as tops
from repro_torch.kernels.corridor_scan import corridor_scan, corridor_scan_twin
from repro_torch.tune import device_fit as tdf

from conftest import TABLE_KINDS, make_table
from test_torch_gpu import clamp_table

#: adjacent keys at 2^60 collide in f64: dx = 0, NaN cones
_COLLIDING = (np.uint64(1) << np.uint64(60)) + np.arange(1024, dtype=np.uint64)
N = 1024
TABLES = TABLE_KINDS + ("clamp", "colliding")
EPS = (4.0, 32.0)

_r_pgm_scan = jax.jit(rpgm.pgm_segments_scan)
_r_rs_scan = jax.jit(rrs.rs_knots_scan)
_r_pgm_fast = jax.jit(rpgm.pgm_fit_fast)
_r_rs_fast = jax.jit(rrs.rs_knots_fast)


def _table(name: str, n: int = N) -> np.ndarray:
    """``n`` sorted unique keys of the named shape (every shape resampled
    evenly to ``n`` keys, which keeps its CDF)."""
    if name == "colliding":
        return _COLLIDING[:n]
    t = clamp_table()[0] if name == "clamp" else make_table(np.random.default_rng(7), name, 2 * n)
    return t[np.linspace(0, len(t) - 1, n).astype(np.int64)]


def _f64(t):
    return t.astype(np.float64)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# -- the corridor scans --------------------------------------------------------------


@pytest.mark.parametrize("name", TABLES)
def test_scan_masks_match_reference(name):
    k = _f64(_table(name))
    for eps in EPS:
        got = tpgm.pgm_segments_scan(k, eps)
        np.testing.assert_array_equal(_np(got), _np(_r_pgm_scan(k, eps)), err_msg=f"pgm {eps}")
        if name != "colliding":  # the greedy's own starts
            np.testing.assert_array_equal(np.flatnonzero(_np(got)),
                                          tpgm.pla_segments(k, int(eps))[0])
        cnt = N // 3  # a live prefix, as PGM's upper levels carry
        np.testing.assert_array_equal(
            _np(tpgm.pgm_segments_scan(k, eps, count=cnt)),
            _np(_r_pgm_scan(k, eps, count=jnp.asarray(cnt))), err_msg=f"pgm count {eps}")
        got = trs.rs_knots_scan(k, eps)
        np.testing.assert_array_equal(_np(got), _np(_r_rs_scan(k, eps)), err_msg=f"rs {eps}")
        if name != "colliding":
            np.testing.assert_array_equal(np.flatnonzero(_np(got)), trs.spline_knots(k, eps))


@pytest.mark.parametrize("name", TABLES)
def test_fast_fits_match_reference(name):
    k = _f64(_table(name))
    for eps in EPS:
        mask, ok = tpgm.pgm_fit_fast(k, eps)
        want, want_ok = _r_pgm_fast(k, eps)
        np.testing.assert_array_equal(_np(mask), _np(want), err_msg=f"pgm {eps}")
        assert bool(ok) == bool(want_ok) == (name != "colliding")
        mask, ok = tpgm.pgm_fit_fast(k, eps, count=N // 3)
        want, want_ok = _r_pgm_fast(k, eps, count=jnp.asarray(N // 3))
        np.testing.assert_array_equal(_np(mask), _np(want), err_msg=f"pgm count {eps}")
        assert bool(ok) == bool(want_ok)
        mask, ok = trs.rs_knots_fast(k, eps)
        want, want_ok = _r_rs_fast(k, eps)
        np.testing.assert_array_equal(_np(mask), _np(want), err_msg=f"rs {eps}")
        assert bool(ok) == bool(want_ok) == (name != "colliding")


@pytest.mark.parametrize("n", (1, 2, 3))
def test_tiny_tables(n):
    k = _f64(np.arange(n, dtype=np.uint64) * 5 + 1)
    for port, ref in ((tpgm.pgm_segments_scan, _r_pgm_scan), (trs.rs_knots_scan, _r_rs_scan)):
        np.testing.assert_array_equal(_np(port(k, 4.0)), _np(ref(k, 4.0)))
    for port, ref in ((tpgm.pgm_fit_fast, _r_pgm_fast), (trs.rs_knots_fast, _r_rs_fast)):
        (m1, ok1), (m2, ok2) = port(k, 4.0), ref(k, 4.0)
        np.testing.assert_array_equal(_np(m1), _np(m2))
        assert bool(ok1) == bool(ok2)


def test_stack_is_one_launch_of_each_row():
    """A stack of tables with one ε a row gives each table's own masks (the
    batch axis of one kernel launch), and the twin is the CPU path: no
    launch counted."""
    ts = [_table(name) for name in TABLE_KINDS]
    eps = np.asarray([4.0, 8.0, 16.0, 32.0, 64.0])
    stack = torch.from_numpy(np.stack([_f64(t) for t in ts]))
    kernels.reset_launches()
    scan = tpgm.pgm_segments_scan(stack, torch.from_numpy(eps))
    fast, ok = trs.rs_knots_fast(stack, torch.from_numpy(eps))
    assert kernels.launches()["corridor_scan"] == 0
    for i, t in enumerate(ts):
        np.testing.assert_array_equal(_np(scan[i]), _np(tpgm.pgm_segments_scan(_f64(t), eps[i])))
        m1, ok1 = trs.rs_knots_fast(_f64(t), eps[i])
        np.testing.assert_array_equal(_np(fast[i]), _np(m1))
        assert bool(ok[i]) == bool(ok1)


def test_corridor_scan_checks_its_operands():
    k = torch.zeros((2, 8), dtype=torch.float64)
    eps = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown recurrence"):
        corridor_scan(k, eps, recurrence="btree", length=8, chunk=8)
    with pytest.raises(ValueError, match="length"):
        corridor_scan(k, eps, recurrence="rs", length=8, chunk=8)  # reads keys[j + 1]
    with pytest.raises(TypeError, match="float64"):
        corridor_scan(k.float(), eps, recurrence="pgm", length=8, chunk=8)
    with pytest.raises(ValueError):
        corridor_scan(k, torch.ones(3, dtype=torch.float64), recurrence="pgm", length=8, chunk=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        corridor_scan(k.to("meta"), eps.to("meta"), recurrence="pgm", length=8, chunk=8)
    # the blocked form with a block of 1: every element starts a fresh row
    flags = corridor_scan_twin(k + torch.arange(8.0), eps, recurrence="pgm", length=8, chunk=1)
    assert bool(flags.all())


# -- device helpers ----------------------------------------------------------------------


def test_bit_length_and_ceil_log2_at_the_edges():
    vals = np.array([0, 1, 2, 3, 2**53 - 1, 2**53, 2**53 + 1, 2**63 - 1, 2**63, 2**63 + 1,
                     2**64 - 2, 2**64 - 1], dtype=np.uint64)
    got = tcdf.bit_length_device(torch.from_numpy(vals.view(np.int64)))
    np.testing.assert_array_equal(_np(got), _np(rcdf.bit_length_device(jnp.asarray(vals))))
    assert got.dtype == torch.int32
    ints = np.array([0, 1, 2, 3, 4, 5, 2**31, 2**31 + 1, 2**53 - 1, 2**53, 2**53 + 1, 2**62 + 1])
    np.testing.assert_array_equal(_np(tcdf.ceil_log2_device(torch.from_numpy(ints))),
                                  _np(rcdf.ceil_log2_device(jnp.asarray(ints))))
    assert [int(tcdf.ceil_log2_device(torch.tensor(x))) for x in (1, 2, 3, 1000)] == [
        rcdf.ceil_log2(x) for x in (1, 2, 3, 1000)]


@pytest.mark.parametrize("name", TABLES)
def test_segment_ids_match_reference(name):
    mask = _np(tpgm.pgm_fit_fast(_f64(_table(name)), 8.0)[0])
    seg, start = tcdf.segment_ids(torch.from_numpy(mask))
    want_seg, want_start = jax.jit(rcdf.segment_ids)(jnp.asarray(mask))
    np.testing.assert_array_equal(_np(seg), _np(want_seg))
    np.testing.assert_array_equal(_np(start), _np(want_start))


def test_segment_reductions_propagate_nan():
    v = torch.tensor([[1.0, float("nan"), 3.0, -2.0], [5.0, 6.0, float("-inf"), 8.0]],
                     dtype=torch.float64)
    seg = torch.tensor([[0, 0, 1, 1], [0, 1, 1, 3]])
    mx = tcdf.segment_max(v, seg, 4)
    mn = tcdf.segment_min(v, seg, 4)
    for got, fn in ((mx, jax.ops.segment_max), (mn, jax.ops.segment_min)):
        want = np.stack([np.asarray(fn(jnp.asarray(v[i].numpy()), jnp.asarray(seg[i].numpy()),
                                       num_segments=4)) for i in range(2)])
        np.testing.assert_array_equal(_np(got), want)
    lengths = torch.tensor([[2, 0, 2], [1, 3, 0]])
    sums = tcdf.segment_sum(torch.tensor([[1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0]],
                                         dtype=torch.float64), lengths)
    np.testing.assert_array_equal(_np(sums), [[3.0, 0.0, 7.0], [1.0, 9.0, 0.0]])


@pytest.mark.parametrize("name", TABLES)
def test_device_slopes_and_verified_eps_match_reference(name):
    t = _table(name)
    k = _f64(t)
    for eps in EPS:
        for mask in (_np(tpgm.pgm_segments_scan(k, eps)), _np(tpgm.pgm_fit_fast(k, eps)[0])):
            got = tpgm.pgm_device_slopes(k, torch.from_numpy(mask), eps)
            want = rpgm.pgm_device_slopes(jnp.asarray(k), jnp.asarray(mask), eps)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), _np(w))
            starts = np.flatnonzero(mask)
            if name != "colliding":  # the host slopes, bit for bit
                np.testing.assert_array_equal(_np(got[0])[:len(starts)],
                                              tpgm.segment_slopes(k, starts, eps))
            np.testing.assert_array_equal(
                _np(tpgm.pgm_verified_eps(k, torch.from_numpy(mask), eps)),
                _np(rpgm.pgm_verified_eps(jnp.asarray(k), jnp.asarray(mask), eps)))
            cnt = N // 3
            np.testing.assert_array_equal(
                _np(tpgm.pgm_verified_eps(k, torch.from_numpy(mask), eps, count=cnt)),
                _np(rpgm.pgm_verified_eps(jnp.asarray(k), jnp.asarray(mask), eps,
                                          count=jnp.asarray(cnt))))
        kmask = _np(trs.rs_knots_fast(k, eps)[0])
        np.testing.assert_array_equal(_np(trs.rs_verified_eps(k, torch.from_numpy(kmask))),
                                      _np(rrs.rs_verified_eps(jnp.asarray(k), jnp.asarray(kmask))))


@pytest.mark.parametrize("root", ("linear", "cubic", "spline"))
@pytest.mark.parametrize("name", TABLE_KINDS + ("clamp",))
def test_rmi_leaf_fit_matches_reference(name, root):
    t = _table(name)
    coef, kmin, inv_span = rrmi.fit_root(t, root)
    u = np.clip((_f64(t) - kmin) * inv_span, 0.0, 1.0)
    b = 64
    got = [_np(a) for a in trmi.rmi_leaf_fit(torch.from_numpy(u), torch.from_numpy(coef), b)]
    want = [_np(a) for a in rrmi.rmi_leaf_fit(jnp.asarray(u), jnp.asarray(coef), b)]
    np.testing.assert_array_equal(got[3], want[3])  # r
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    assert np.abs(got[2] - want[2]).max() <= 1
    model = trmi.assemble_rmi(t, root, coef, kmin, inv_span, *got)
    lo, hi = model.intervals(keys.encode(t, "cpu"), keys.encode(t, "cpu"))
    ranks = np.arange(len(t))
    assert ((_np(lo) - 1 <= ranks) & (ranks <= _np(hi))).all()  # every rank in its window


@pytest.mark.parametrize("name", TABLE_KINDS + ("clamp",))
def test_device_reencoders_match_host(name):
    t = _table(name)
    m = tpgm.build_pgm(t, eps=8)
    host, _ = tops.pgm_kernel_arrays(m, t)
    kmin = torch.tensor(np.float64(t[0]), dtype=torch.float64)
    span = torch.tensor(np.float64(t[-1]) - np.float64(t[0]), dtype=torch.float64)
    inv_span = torch.where(span > 0, 1.0 / span, torch.ones_like(span))
    levels = len(m.level_keys)
    u0, sl, errs = [], [], []
    for lvl in range(levels):
        cap = len(t)
        size = m.level_sizes[lvl]
        pad = np.full(cap - size, np.iinfo(np.uint64).max, dtype=np.uint64)
        lk = keys.encode(np.concatenate([m.level_keys[lvl], pad]), "cpu")
        ls = torch.from_numpy(np.concatenate([m.level_slope[lvl], np.zeros(cap - size)]))
        st = torch.from_numpy(np.concatenate([m.level_rank0[lvl][:-1], np.zeros(cap - size,
                                                                                 np.int64)]))
        child = m.level_keys[lvl + 1] if lvl + 1 < levels else t
        cpad = np.full(cap - len(child), np.iinfo(np.uint64).max, dtype=np.uint64)
        a, b, e = tops.pgm_level_reencode_device(
            lk, ls, st, torch.tensor(size), keys.encode(np.concatenate([child, cpad]), "cpu"),
            torch.tensor(len(child)), kmin, span, inv_span)
        u0.append(_np(a)[:size])
        sl.append(_np(b)[:size])
        errs.append(float(e))
    np.testing.assert_array_equal(np.concatenate(u0), host["u0"])
    np.testing.assert_array_equal(np.concatenate(sl), host["slope"])
    assert int(min(np.ceil(max(errs)) + 2, len(t))) == host["eps"]

    r = trs.build_rs(t, eps=8, r_bits=8)
    host, _ = tops.rs_kernel_arrays(r, t)
    cap = 1 << int(np.ceil(np.log2(r.m)))
    kk = keys.encode(np.concatenate([r.knot_keys, np.full(cap - r.m, np.iinfo(np.uint64).max,
                                                           dtype=np.uint64)]), "cpu")
    kr = torch.from_numpy(np.concatenate([r.knot_ranks, np.full(cap - r.m, len(t) - 1)]))
    u0, slope, rk_eps = tops.rs_kernel_arrays_device(kk, kr, torch.tensor(r.m),
                                                     keys.encode(t, "cpu"), kmin, span, inv_span)
    np.testing.assert_array_equal(_np(u0)[:r.m], host["u0"])
    np.testing.assert_array_equal(_np(slope)[:r.m], host["slope"])
    assert int(rk_eps) == host["eps"] and rk_eps.dtype == torch.int32


LAST_KEYS = (2**63 - 1, 2**63, 2**64 - 2, 2**64 - 1 - 5, 2**64 - 1 - 4, 2**64 - 1, 10)


@pytest.mark.parametrize("last", LAST_KEYS)
def test_pad_sorted_table_device_at_the_unsigned_edges(last):
    m, count = 8, 3
    raw = np.array([last - 2, last - 1, last], dtype=np.uint64)
    want = tsi._pad_sorted_table(raw, m)
    row = np.zeros(m, dtype=np.uint64)
    row[:count] = raw
    got = tdf.pad_sorted_table_device(keys.encode(row, "cpu"), torch.tensor(count), m)
    np.testing.assert_array_equal(keys.decode(got), want)
    ref = rdf.pad_sorted_table_device(jnp.asarray(row), jnp.asarray(count), m)
    np.testing.assert_array_equal(np.asarray(ref), want)


# -- build_many / build_grid ----------------------------------------------------------

PARAMS = {
    "RMI": {"b": 64},
    "SY-RMI": {"space_pct": 2.0, "ub": 0.04},
    "PGM": {"eps": 16},
    "PGM_M": {"space_pct": 2.0, "a": 1.0},
    "RS": {"eps": 16, "r_bits": 8},
    "KO": {"k": 7},
    "BTREE": {"fanout": 8},
    "L": {},
}


def _assert_leaves(want: dict, got: dict, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (what, k)
        assert got[k].tobytes() == want[k].tobytes(), (what, k)


def _same(n=N):
    return [_table(k, n) for k in ("uniform", "sequential", "clustered")]


def _ragged():
    return [_table("lognormal", 1000), _table("bursty", 700)]


def _queries(tables):
    qs = np.concatenate(tables)
    with np.errstate(over="ignore"):
        return np.concatenate([qs, qs + np.uint64(1), np.array([0, 2**64 - 1], dtype=np.uint64)])


@pytest.mark.parametrize("batch", ("same", "ragged"))
@pytest.mark.parametrize("kind,fit", [(k, "vmap") for k in ttune.VMAP_KINDS] +
                         [(k, "fast") for k in ttune.FAST_KINDS])
def test_build_many_fits_match_reference(kind, fit, batch):
    """PGM, PGM_M and RS: the reference's leaves (vmap: the host build's
    too); the RMI family: the host build's leaves (the reference's vmap
    fit is off by a few ulp), its ``r`` and ε within ±1, ranks exact."""
    tables = _same() if batch == "same" else _ragged()
    rspec, tspec = rix.spec_for(kind, **PARAMS[kind]), tix.spec_for(kind, **PARAMS[kind])
    got = ttune.build_many(tspec, tables, fit=fit, device="cpu")
    ref = rtune.build_many(rspec, tables, fit=fit)
    have = got.index.to_numpy()
    want = {k: np.asarray(v) for k, v in ref.index.arrays.items()}
    assert got.index.static == ref.index.static
    if kind in ("RMI", "SY-RMI"):
        np.testing.assert_array_equal(have["leaf_r"], want["leaf_r"])
        assert np.abs(have["leaf_eps"] - want["leaf_eps"]).max() <= 1
        host = rtune.build_many(rspec, tables)
        _assert_leaves({k: np.asarray(v) for k, v in host.index.arrays.items()}, have, kind)
    else:
        _assert_leaves(want, have, (kind, fit))
        if fit == "vmap":
            _assert_leaves(ttune.build_many(tspec, tables, device="cpu").index.to_numpy(), have,
                           "host")
    qs = _queries(tables)
    ranks = got.lookup(qs).numpy()
    for i, t in enumerate(tables):
        np.testing.assert_array_equal(ranks[i], true_ranks(t, qs), err_msg=f"{kind}/{i}")


@pytest.mark.parametrize("kind", ("L", "KO", "BTREE", "RMI", "PGM", "RS"))
def test_build_many_auto_is_vmap_or_host(kind):
    tables = _same(512)
    spec = tix.spec_for(kind, **PARAMS[kind])
    auto = ttune.build_many(spec, tables, fit="auto", device="cpu").index.to_numpy()
    other = "vmap" if kind in ttune.VMAP_KINDS else "host"
    _assert_leaves(ttune.build_many(spec, tables, fit=other, device="cpu").index.to_numpy(), auto,
                   kind)


@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_build_many_fast_falls_back_per_member(kind, monkeypatch):
    """The colliding member fails the verified ε and is re-fit with the
    exact scan (its mask equals the scan's); the healthy member keeps its
    fast fit; leaves equal the reference's, ranks exact."""
    good = distributions.generate("osm", 1024, seed=3)
    tables = [_COLLIDING, good]
    spec = PARAMS[kind]
    scans = []
    scan_name = "_masks_pgm_scan" if kind == "PGM" else "_masks_rs_scan"
    real = getattr(ttune.batched, scan_name)

    def counting(keys_f, eps_np):
        scans.append(real(keys_f, eps_np))
        return scans[-1]

    monkeypatch.setattr(ttune.batched, scan_name, counting)
    got = ttune.build_many(tix.spec_for(kind, **spec), tables, fit="fast", device="cpu")
    assert len(scans) == 1 and scans[0].shape[0] == 1  # the colliding member alone
    scan = tpgm.pgm_segments_scan if kind == "PGM" else trs.rs_knots_scan
    np.testing.assert_array_equal(scans[0][0], _np(scan(_f64(_COLLIDING), float(spec["eps"]))))
    ref = rtune.build_many(rix.spec_for(kind, **spec), tables, fit="fast")
    _assert_leaves({k: np.asarray(v) for k, v in ref.index.arrays.items()},
                   got.index.to_numpy(), kind)
    qs = np.sort(np.random.default_rng(0).choice(good, 256))
    np.testing.assert_array_equal(got.lookup(qs).numpy()[1], true_ranks(good, qs))


def test_build_many_refuses_kinds_without_a_device_fit():
    with pytest.raises(ValueError, match="fit='vmap' is not supported"):
        ttune.build_many("KO", _same(256), fit="vmap", device="cpu")
    with pytest.raises(ValueError, match="fit='fast' is not supported"):
        ttune.build_many("RMI", _same(256), fit="fast", device="cpu")
    with pytest.raises(ValueError, match="unknown fit"):
        ttune.build_many("RMI", _same(256), fit="greedy", device="cpu")
    with pytest.raises(ValueError, match="one branching factor"):
        ttune.batched._vmap_fit_rmi([tix.RMISpec(b=8), tix.RMISpec(b=16)], _same(256)[:2], "cpu")


GRID = [("RMI", {"b": 64, "root_type": r}) for r in ("linear", "cubic", "spline")] + [
    ("SY-RMI", {"space_pct": 2.0, "ub": 0.04, "winner_root": "cubic"}),
    ("PGM", {"eps": 8}), ("PGM", {"eps": 16}), ("PGM", {"eps": 64}),
    ("PGM_M", {"space_pct": 2.0, "a": 1.0}),
    ("RS", {"eps": 16, "r_bits": 8}), ("RS", {"eps": 32, "r_bits": 8}),
    ("KO", {"k": 7}),
]


@pytest.mark.parametrize("fit", ("auto", "fast"))
def test_build_grid_matches_reference(fit, monkeypatch):
    t = _table("lognormal", 1024)
    launches = []
    real = ttune.batched.pgm_segments_scan

    def counting(*a, **kw):
        launches.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ttune.batched, "pgm_segments_scan", counting)
    got = ttune.build_grid([tix.spec_for(k, **p) for k, p in GRID], t, fit=fit, device="cpu")
    want = rtune.build_grid([rix.spec_for(k, **p) for k, p in GRID], t, fit=fit)
    if fit == "auto":
        assert len(launches) == 1  # the PGM ε grid: one scan of a stack of three
    qs = _queries([t])
    for (kind, p), g, w in zip(GRID, got, want):
        assert g.kind == w.kind == kind and g.static == w.static
        if kind in ("RMI", "SY-RMI"):
            host = rix.build(rix.spec_for(kind, **p), t)
            _assert_leaves({k: np.asarray(v) for k, v in host.arrays.items()}, g.to_numpy(), kind)
        else:
            _assert_leaves({k: np.asarray(v) for k, v in w.arrays.items()}, g.to_numpy(), kind)
        np.testing.assert_array_equal(g.lookup(t, qs).numpy(), true_ranks(t, qs))


# -- device_refresh ------------------------------------------------------------------

_SPECS = {"PGM": {"eps": 32}, "RS": {"eps": 16, "r_bits": 8}}


def _tiers(kind, tmp_path):
    """The reference's 4-shard tier over 8,000 osm keys and the port's
    load of its npz (the bridge between the packages)."""
    table = distributions.generate("osm", 8000, seed=0)
    ref = rsi.ShardedIndex.build(rix.spec_for(kind, **_SPECS[kind]), table, n_shards=4)
    path = tmp_path / "tier.npz"
    ref.save(str(path))
    return table, ref, tsi.ShardedIndex.load(str(path), device="cpu")


def _merged(ref, shard=1, n_new=40, seed=1):
    cnt = int(ref.counts[shard])
    old = np.asarray(ref.tables[shard][:cnt])
    drift = np.unique(np.random.default_rng(seed).integers(int(old[10]), int(old[-10]), n_new,
                                                           dtype=np.uint64))
    return drift, np.union1d(old, drift)


def _tier_state(sidx) -> dict:
    out = {f"leaf:{k}": v for k, v in sidx.index.to_numpy().items()}
    for name in ("tables", "fences", "counts", "offsets", "lasts"):
        out[name] = getattr(sidx, name).numpy().copy()
    return out


def _live_model(kind: str, state: dict, row: int) -> dict:
    """Shard ``row``'s leaves cut to the model's live prefix: past it the
    device program writes the host build's pad sentinels, where
    ``refresh_shard`` repeats the last entry up to the stacked width."""
    leaf = {k[5:]: v[row] for k, v in state.items() if k.startswith("leaf:")}
    if kind == "PGM":
        kv = int(leaf["sizes"].sum())
        cut = {k: kv for k in ("keys", "slope", "pk_u0", "pk_slope")}
        cut["rank0"] = kv + len(leaf["sizes"])
    else:
        cut = {k: int(leaf["m_valid"]) for k in ("knot_keys", "knot_ranks", "rk_u0", "rk_slope")}
    return {k: v[:cut[k]] if k in cut else v for k, v in leaf.items()}


@pytest.mark.parametrize("fit", ("fast", "scan"))
@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_device_refresh_matches_reference(kind, fit, tmp_path):
    """The installed leaves, table row, fences, counts and offsets equal the
    reference's program's, and ``ok`` agrees; on ``ok`` the tier serves the
    merged keys exactly, else the old ones (both arms of the contract)."""
    table, ref, port = _tiers(kind, tmp_path)
    drift, merged = _merged(ref)
    eps = _SPECS[kind]["eps"]
    kernels.reset_launches()
    checks = {}
    same, ok = ttune.device_refresh(port, 1, merged, eps, fit=fit, checks=checks)
    assert same is port and ok.dtype == torch.bool and ok.dim() == 0
    assert bool(ok) == all(bool(v) for v in checks.values())
    assert kernels.launches()["corridor_scan"] == 0  # the CPU runs the twin
    ref2, ref_ok = rdf.device_refresh(ref, 1, merged, eps=eps, fit=fit)
    assert bool(ok) == bool(ref_ok)
    if fit == "scan":
        assert bool(ok)
    _assert_leaves({k: np.asarray(v) for k, v in ref2.index.arrays.items()},
                   port.index.to_numpy(), (kind, fit))
    np.testing.assert_array_equal(keys.decode(port.tables), np.asarray(ref2.tables))
    np.testing.assert_array_equal(keys.decode(port.fences), np.asarray(ref2.fences))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref2.counts))
    np.testing.assert_array_equal(port.offsets.numpy(), np.asarray(ref2.offsets))
    served = np.union1d(table, drift) if bool(ok) else table
    assert keys.decode(port.lasts)[1] == (merged[-1] if bool(ok) else table[3999])
    qs = np.sort(np.random.default_rng(2).choice(served, 512))
    for backend in ("kernel", "xla"):
        np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend=backend).numpy(),
                                      true_ranks(served, qs))


@pytest.mark.parametrize("fit", ("fast", "scan"))
@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_device_refresh_scan_equals_the_host_refresh(kind, fit, tmp_path):
    """``fit="scan"`` installs the host build's model of the merged shard
    (``refresh_shard`` of ``build`` on ``shard_build_table``), bit for bit
    over the model's live leaves and the tier's other tensors; a refused
    refresh (the merged row crosses the next fence, or starts inside the
    previous shard) changes nothing at all."""
    _, ref, port = _tiers(kind, tmp_path)
    _, merged = _merged(ref)
    eps = _SPECS[kind]["eps"]
    if fit == "scan":
        host = tsi.ShardedIndex.load(str(tmp_path / "tier.npz"), device="cpu")
        m = int(host.tables.shape[1])
        built = tix.build(tix.spec_for(kind, **_SPECS[kind]),
                          tsi.shard_build_table(kind, merged, m), device="cpu")
        tsi.refresh_shard(host, 1, built, merged)
        ttune.device_refresh(port, 1, merged, eps, fit=fit)
        want, got = _tier_state(host), _tier_state(port)
        assert want.keys() == got.keys()
        for k, v in want.items():
            w, g = v, got[k]
            if k.startswith("leaf:"):  # the other shards' rows
                w, g = np.delete(w, 1, axis=0), np.delete(g, 1, axis=0)
            assert w.tobytes() == g.tobytes(), k
        _assert_leaves(_live_model(kind, want, 1), _live_model(kind, got, 1), kind)
    before = _tier_state(port)
    nxt = keys.decode(port.fences)[2]
    prev_last = keys.decode(port.lasts)[0]
    for bad in (np.append(merged, nxt), np.concatenate([[prev_last], merged[1:]])):
        _, ok = ttune.device_refresh(port, 1, bad, eps, fit=fit)
        assert not bool(ok)
        after = _tier_state(port)
        for k, v in before.items():
            assert v.tobytes() == after[k].tobytes(), k


@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_device_refresh_names_the_term_that_refuses(kind, tmp_path):
    """``checks`` tells which term vetoed a refresh: a merged row that
    crosses the next fence fails ``fences`` alone, and one whose model
    outgrows the tier's leaf rows fails ``leaf_capacity`` (the reference
    refuses both too); either way the tier is left as it was."""
    _, ref, port = _tiers(kind, tmp_path)
    _, merged = _merged(ref)
    eps = _SPECS[kind]["eps"]
    crossing = np.append(merged, keys.decode(port.fences)[2])
    # clusters of 80 keys 2^12 apart (distinct in f64) behind random gaps:
    # each a rank step past 2ε, so segments and knots outgrow the rows
    # sized for osm's shard
    lo, hi = int(merged[0]), int(merged[-1])
    step = np.arange(80, dtype=np.uint64) << np.uint64(12)
    starts = np.unique(np.random.default_rng(3).integers(lo, hi - (80 << 12),
                                                         len(merged) // 80, dtype=np.uint64))
    assert np.diff(starts).min() > (80 << 12)
    clustered = (starts[:, None] + step).reshape(-1)
    cap = port.index.arrays["keys" if kind == "PGM" else "knot_keys"].shape[1]
    built = tix.build(tix.spec_for(kind, **_SPECS[kind]), clustered, device="cpu")
    assert built.to_numpy()["m_valid" if kind == "RS" else "sizes"].sum() > cap
    for fit in ("fast", "scan"):
        for row, want in ((crossing, {"fences"}), (clustered, {"leaf_capacity"})):
            before = _tier_state(port)
            checks = {}
            _, ok = ttune.device_refresh(port, 1, row, eps, fit=fit, checks=checks)
            failed = {k for k, v in checks.items() if not bool(v)}
            assert want <= failed and not bool(ok), (fit, failed)
            if row is crossing and fit == "scan":
                assert failed == want
            ref, ref_ok = rdf.device_refresh(ref, 1, row, eps=eps, fit=fit)  # donates ref
            assert not bool(ref_ok)
            for k, v in _tier_state(port).items():
                assert v.tobytes() == before[k].tobytes(), k


@pytest.mark.parametrize("kind", ("PGM", "RS"))
def test_device_refresh_fast_installs_where_the_rows_have_room(kind, tmp_path):
    """On a tier whose shard 0 holds 1.5 times shard 1's keys, the leaf rows
    have room for the fast fit's extra segments and knots: the fast refresh
    of shard 1 installs (every check passes, as in the reference), its
    leaves equal the reference's, and the tier serves the merged keys."""
    table = distributions.generate("osm", 8000, seed=0)
    held = np.sort(np.random.default_rng(4).choice(np.arange(3008, 4992), 40, replace=False))
    base = np.delete(table, held)
    ref = rsi.ShardedIndex.build(rix.spec_for(kind, **_SPECS[kind]), base, n_shards=4,
                                 bounds=[0, 3000, 4960, 6460, 7960])
    ref.save(str(tmp_path / "tier.npz"))
    port = tsi.ShardedIndex.load(str(tmp_path / "tier.npz"), device="cpu")
    merged, eps = table[3000:5000], _SPECS[kind]["eps"]
    checks = {}
    _, ok = ttune.device_refresh(port, 1, merged, eps, fit="fast", checks=checks)
    assert bool(ok) and all(bool(v) for v in checks.values()), checks
    ref2, ref_ok = rdf.device_refresh(ref, 1, merged, eps=eps, fit="fast")
    assert bool(ref_ok)
    _assert_leaves({k: np.asarray(v) for k, v in ref2.index.arrays.items()},
                   port.index.to_numpy(), kind)
    qs = np.sort(np.random.default_rng(5).choice(table, 512))
    np.testing.assert_array_equal(tsi.sharded_lookup(port, qs, backend="kernel").numpy(),
                                  true_ranks(table, qs))


def test_device_refresh_host_side_rejections(tmp_path):
    table, ref, port = _tiers("PGM", tmp_path)
    rmi = tsi.ShardedIndex.build(tix.RMISpec(b=64), table, n_shards=4, device="cpu")
    with pytest.raises(ValueError, match="device_refresh supports"):
        ttune.device_refresh(rmi, 0, table[:100], eps=32)
    cap = int(port.tables.shape[1])
    with pytest.raises(ValueError, match="restack the tier"):
        ttune.device_refresh(port, 0, np.arange(1, cap + 2, dtype=np.uint64), eps=32)
    with pytest.raises(ValueError, match="restack the tier"):
        ttune.device_refresh(port, 0, np.zeros(0, dtype=np.uint64), eps=32)
    with pytest.raises(ValueError, match="unknown device fit"):
        ttune.device_refresh(port, 0, table[:100], eps=32, fit="greedy")
    one = tsi.ShardedIndex.build(tix.PGMSpec(eps=4), np.arange(1, 5, dtype=np.uint64), 4,
                                 device="cpu")
    with pytest.raises(ValueError, match="capacity-1 tier"):
        ttune.device_refresh(one, 0, np.array([1], dtype=np.uint64), eps=4)
    with pytest.raises(ValueError, match="encoded int64"):
        ttune.device_refresh(port, 0, torch.zeros(4, dtype=torch.float64), eps=32)
    held = tsi.ShardedIndex.load(str(tmp_path / "tier.npz"), device="cpu", shard=1)
    with pytest.raises(ValueError, match="holds every shard"):
        ttune.device_refresh(held, 1, table[2000:2100], eps=32)


def test_device_refresh_takes_an_encoded_tensor(tmp_path):
    _, ref, port = _tiers("RS", tmp_path)
    _, merged = _merged(ref)
    twin = tsi.ShardedIndex.load(str(tmp_path / "tier.npz"), device="cpu")
    _, ok1 = ttune.device_refresh(port, 1, keys.encode(merged, "cpu"), 16, fit="scan")
    _, ok2 = ttune.device_refresh(twin, 1, merged, 16, fit="scan")
    assert bool(ok1) and bool(ok2)
    for k, v in _tier_state(twin).items():
        assert v.tobytes() == _tier_state(port)[k].tobytes(), k


# -- tables -----------------------------------------------------------------------------


def test_subsample_and_bench_tables_match_reference():
    parent = distributions.generate("osm", 20000, seed=0)
    for n in (500, 4000):
        np.testing.assert_array_equal(ttables.subsample_preserving_cdf(parent, n, seed=3),
                                      rtables.subsample_preserving_cdf(parent, n, seed=3))
    assert ttables.ks_statistic(parent[::7], parent) == rtables.ks_statistic(parent[::7], parent)
    assert ttables.kl_divergence(parent[::7], parent) == rtables.kl_divergence(parent[::7], parent)
    tiers = {"L1": 256, "L2": 2048}
    got = ttables.make_bench_tables(("osm", "face"), tiers=tiers, seed=1, scale=0.5)
    want = rtables.make_bench_tables(("osm", "face"), tiers=tiers, seed=1, scale=0.5)
    assert [b.name for b in got] == [b.name for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.table, w.table)
    assert ttables.TIERS == rtables.TIERS
    # every candidate rejected: the stratified fallback
    np.testing.assert_array_equal(ttables.subsample_preserving_cdf(parent, 100, tries=0),
                                  rtables.subsample_preserving_cdf(parent, 100, tries=0))
