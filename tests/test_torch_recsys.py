"""The port's recsys serving path (``configs``, ``models.embedding``,
``models.recsys`` and the ``serve``/``retrieval`` cells of
``launch.steps``) held against the JAX reference on the CPU.

The same weights (the reference's ``recsys.init``, carried across with
``params_from_numpy``) and the same seeded numpy batches go through both;
the reference calls are jitted.  Tolerances: f32 logits within 2e-5
absolute and relative (|logit| < 1 on the reduced configs; sums in another
order: measured differences below 3e-7).  Ids, ranks and gathered rows are
exact: no tolerance.

DIN's retrieval runs the reference with ``lookup_mode="allreduce"``: under
its default ``"a2a"`` the reference raises ``ShardingTypeError`` at the
``concatenate`` of ``_din_interest`` (ROADMAP queue 3); the port's
one-rank lookup is a gather in both modes.  DIN's retrieval reads the
profile row without field 1's offset, as the reference's does (queue 3):
``test_din_retrieval_gap_is_the_profile_row`` shows the gap to
``score_fn`` comes from that row alone.

The mega-table lookup on 4 spawned gloo ranks (one row shard a rank) is
held against the reference's ``sharded_lookup`` and ``score_fn`` on 4
forced host devices, run once in a subprocess beside the ranks (module
fixture ``ranks``), skewed batches' dropped rows included.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist.sharding import single_device_ctx
from repro.launch import steps as rsteps
from repro.models import embedding as rembed
from repro.models import recsys as rr
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.launch import steps as tsteps
from repro_torch.models import embedding as tembed
from repro_torch.models import recsys as tr

from test_torch_gpu import embedding_rank_cases, run_ranks

TOL = 2e-5
RECSYS_ARCHS = ("dlrm-mlperf", "din", "wide-deep", "sasrec")
SERVING_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
LM_ARCHS = ("granite-3-8b", "minitron-8b", "qwen2-0.5b", "moonshot-v1-16b-a3b",
            "qwen3-moe-235b-a22b")
CTX = single_device_ctx()
SRC = Path(__file__).resolve().parents[1] / "src"


def _specs(arch):
    return rconfigs.get(arch, reduced=True), tconfigs.get(arch, reduced=True)


def _cell(spec, name):
    return next(c for c in spec.shapes if c.name == name)


@functools.lru_cache(maxsize=None)
def _ref_init(cfg_r, seed):
    return jax.tree.map(np.asarray, jax.jit(lambda k: rr.init(k, cfg_r))(jax.random.key(seed)))


def _params(cfg_r, seed=0):
    """The reference's initial parameters (numpy leaves) and the port's
    copy; ``lookup_mode`` does not enter the draws."""
    rp = _ref_init(dataclasses.replace(cfg_r, lookup_mode="a2a"), seed)
    return rp, tr.params_from_numpy(rp, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_recsys_configs_match_reference(arch, reduced):
    r, t = rconfigs.get(arch, reduced=reduced), tconfigs.get(arch, reduced=reduced)
    assert dataclasses.asdict(t.config) == dataclasses.asdict(r.config)
    assert (t.config.n_sparse, t.config.total_rows) == (r.config.n_sparse, r.config.total_rows)
    assert (t.arch_id, t.family) == (r.arch_id, r.family)
    assert [(c.name, c.kind, c.dims) for c in t.shapes] == [(c.name, c.kind, c.dims) for c in r.shapes]
    np.testing.assert_array_equal(tr.field_offsets(t.config), rr.field_offsets(r.config))


def test_registry_lists_lm_and_recsys_and_refuses_dimenet():
    """Every family is registered since the DimeNet slice: the registry
    lists the reference's archs, and DimeNet's spec (config and shape
    cells, full and reduced) equals the reference's."""
    assert tconfigs.list_archs() == sorted(LM_ARCHS + RECSYS_ARCHS + ("dimenet",))
    assert tconfigs.list_archs() == rconfigs.list_archs()
    for reduced in (False, True):
        r, t = rconfigs.get("dimenet", reduced=reduced), tconfigs.get("dimenet", reduced=reduced)
        assert dataclasses.asdict(t.config) == dataclasses.asdict(r.config)
        assert [(c.name, c.kind, c.dims) for c in t.shapes] == [(c.name, c.kind, c.dims)
                                                               for c in r.shapes]
    assert tr.CRITEO_VOCABS == rr.CRITEO_VOCABS


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_params_from_numpy_and_init_layout(arch):
    """The reference's pytree comes across leaf for leaf (lists of MLP
    layers and SASRec blocks included); the port's own ``init`` draws the
    same layout, and rounds the mega-table up to the shard count."""
    rspec, tspec = _specs(arch)
    rp, tp = _params(rspec.config)
    want, got = _leaves(rp), _leaves(tp)
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and got[name].device.type == "cpu", name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    mine = _leaves(tr.init(torch.Generator().manual_seed(0), tspec.config))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: w.shape for k, w in want.items()}
    three = SimpleNamespace(n=lambda axis: 3 if axis == "row" else 1)  # a mesh of 3 ranks
    rows = tr.init(torch.Generator().manual_seed(0), tspec.config, three)["embed"].shape[0]
    assert rows == -(-tspec.config.total_rows // 3) * 3


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
@pytest.mark.parametrize("cell_name", SERVING_CELLS)
def test_recsys_make_inputs_match_reference(arch, cell_name):
    rspec, tspec = _specs(arch)
    want = rsteps.make_inputs(rspec, _cell(rspec, cell_name), False, np.random.default_rng(4))
    got = tsteps.make_inputs(tspec, _cell(tspec, cell_name), np.random.default_rng(4),
                             device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].numpy().dtype == w.dtype and got[k].device.type == "cpu", k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("arch", RECSYS_ARCHS)
@pytest.mark.parametrize("cell_name", SERVING_CELLS)
def test_serving_cells_match_reference(arch, cell_name):
    """``score_fn`` on ``serve_p99``/``serve_bulk`` and ``retrieval_fn`` on
    ``retrieval_cand``, through each package's ``build_step``; the port on
    the config's own ``lookup_mode`` (``"a2a"``), the reference on
    ``"allreduce"`` for DIN's retrieval (module docstring)."""
    rspec, tspec = _specs(arch)
    rcell, tcell = _cell(rspec, cell_name), _cell(tspec, cell_name)
    if arch == "din" and rcell.kind == "retrieval":
        rspec = dataclasses.replace(rspec, config=dataclasses.replace(
            rspec.config, lookup_mode="allreduce"))
    rp, tp = _params(rspec.config)
    rbatch = rsteps.make_inputs(rspec, rcell, False, np.random.default_rng(6))
    tbatch = tsteps.make_inputs(tspec, tcell, np.random.default_rng(6), device="cpu")
    want = np.asarray(jax.jit(rsteps.build_step(rspec, rcell, CTX).fn)(rp, rbatch))
    bundle = tsteps.build_step(tspec, tcell)
    got = bundle.fn(tp, tbatch)
    n = tcell.dims.get("n_candidates", tcell.dims["batch"])
    assert bundle.kind == tcell.kind and got.dtype == torch.float32 and tuple(got.shape) == (n,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def _retrieval_as_scores(cfg, batch, n: int):
    """The score batch that scores the first ``n`` candidates of a
    retrieval batch one row each: the user side repeated, the item the
    candidate."""
    c = batch["candidates"][:n].long()
    if cfg.kind == "sasrec":
        return {"seq": batch["seq"].expand(n, -1), "target": c}
    sparse = batch["sparse"].long().expand(n, -1).clone()
    sparse[:, 0] = c
    out = {"sparse": sparse}
    if cfg.kind == "din":
        out["hist"] = batch["hist"].expand(n, -1)
    if cfg.kind == "dlrm":
        out["dense"] = batch["dense"].expand(n, -1)
    return out


@pytest.mark.parametrize("arch", ("dlrm-mlperf", "wide-deep", "sasrec"))
def test_retrieval_equals_score_on_the_same_pairs(arch):
    """For SASRec, DLRM and wide & deep, retrieval's logit of candidate i
    equals ``score_fn`` on the (user, candidate i) pair."""
    spec = tconfigs.get(arch, reduced=True)
    cfg = spec.config
    params = tr.init(torch.Generator().manual_seed(1), cfg)
    batch = tsteps.make_inputs(spec, _cell(spec, "retrieval_cand"), np.random.default_rng(1),
                               device="cpu")
    got = tr.retrieval_fn(params, batch, cfg)[:64]
    want = tr.score_fn(params, _retrieval_as_scores(cfg, batch, 64), cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=TOL)


def test_din_retrieval_gap_is_the_profile_row():
    """DIN's retrieval differs from ``score_fn`` on the same pairs, and
    only through the profile row: scoring with the profile read at row
    ``sparse[0, 1]`` of the mega-table (no field offset, as the
    reference's ``retrieval_fn`` reads it) gives retrieval's values."""
    spec = tconfigs.get("din", reduced=True)
    cfg = spec.config
    params = tr.init(torch.Generator().manual_seed(2), cfg)
    batch = tsteps.make_inputs(spec, _cell(spec, "retrieval_cand"), np.random.default_rng(2),
                               device="cpu")
    got = tr.retrieval_fn(params, batch, cfg)[:64]
    pairs = _retrieval_as_scores(cfg, batch, 64)
    scored = tr.score_fn(params, pairs, cfg)
    assert float((got - scored).abs().max()) > 1e-4  # the reference's profile-row read
    # the profile vector retrieval reads, put where score_fn reads it
    row = int(batch["sparse"][0, 1])
    patched = dict(params, embed=params["embed"].clone())
    patched["embed"][int(tr.field_offsets(cfg)[1]) + row] = params["embed"][row]
    np.testing.assert_allclose(got.numpy(), tr.score_fn(patched, pairs, cfg).numpy(),
                               atol=TOL, rtol=TOL)


def test_din_chunked_retrieval_equals_one_shot(monkeypatch):
    """DIN's retrieval in chunks of 50 candidates (ragged last chunk)
    equals one pass over all 512, value for value."""
    spec = tconfigs.get("din", reduced=True)
    params = tr.init(torch.Generator().manual_seed(3), spec.config)
    batch = tsteps.make_inputs(spec, _cell(spec, "retrieval_cand"), np.random.default_rng(3),
                               device="cpu")
    one_shot = tr.retrieval_fn(params, batch, spec.config)
    assert tr.DIN_RETRIEVAL_CHUNK >= one_shot.shape[0]
    monkeypatch.setattr(tr, "DIN_RETRIEVAL_CHUNK", 50)
    chunked = tr.retrieval_fn(params, batch, spec.config)
    np.testing.assert_allclose(chunked.numpy(), one_shot.numpy(), atol=1e-6, rtol=1e-6)


def test_embedding_bag_matches_reference():
    """take + ``index_add_`` against take + ``segment_sum``, with and
    without weights, unsorted bags, one empty bag and one item whose bag
    lies out of range (it adds nothing in both)."""
    rng = np.random.default_rng(8)
    table = rng.normal(size=(300, 12)).astype(np.float32)
    ids = rng.integers(0, 300, 500).astype(np.int32)
    seg = rng.integers(0, 40, 500).astype(np.int32)
    seg[seg == 7] = 8
    seg[0] = 45
    w = rng.normal(size=500).astype(np.float32)
    for weights in (None, w):
        want = jax.jit(lambda t, i, s, ww: rembed.embedding_bag(t, i, s, 40, ww))(
            table, ids, seg, weights)
        got = tembed.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                                   torch.from_numpy(seg), 40,
                                   None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        assert bool((got[7] == 0).all())


@pytest.mark.parametrize("mode", ("allreduce", "a2a"))
def test_sharded_lookup_one_rank_matches_reference(mode):
    """One rank: both modes are a gather, equal to the reference's."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(500, 6)).astype(np.float32)
    ids = rng.integers(0, 500, (33, 4)).astype(np.int32)
    want = jax.jit(lambda t, i: rembed.sharded_lookup(t, i, CTX, mode=mode))(table, ids)
    got = tembed.sharded_lookup(torch.from_numpy(table), torch.from_numpy(ids), mode=mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the learned-keyed embedding --------------------------------------------------------

LKE_BACKENDS = (("xla", "xla"), ("pallas", "kernel"), ("bbs", "bbs"), ("ref", "ref"))


@pytest.fixture(scope="module")
def lke_inputs():
    rng = np.random.default_rng(12)
    raw = rng.integers(0, 2**64 - 1, 12000, dtype=np.uint64)
    raw = np.concatenate([raw, raw[:500], np.array([0, 2**64 - 1], dtype=np.uint64)])
    keys = np.unique(raw)
    with np.errstate(over="ignore"):
        edges = np.concatenate([keys[:3], keys[-3:], keys[:3] - np.uint64(1),
                                keys[-3:] + np.uint64(1), keys[1:4] + np.uint64(1),
                                np.array([2**63], dtype=np.uint64)])
    queries = np.concatenate([rng.choice(keys, 3000),
                              rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64), edges])
    builds = {n: (rembed.LearnedKeyedEmbedding.build(raw, 8, seed=5, n_shards=n),
                  tembed.LearnedKeyedEmbedding.build(raw, 8, seed=5, n_shards=n, device="cpu"))
              for n in (1, 4)}
    return keys, queries.astype(np.uint64), builds


@pytest.mark.parametrize("n_shards", (1, 4))
def test_learned_keyed_embedding_matches_reference(lke_inputs, n_shards):
    """``build`` on the same raw ids (duplicates, 0 and 2^64 - 1 among
    them): tables equal bit for bit, the keys equal; then every backend's
    ranks and vectors equal the reference's on present, absent and edge
    ids (``"kernel"`` against ``"pallas"``, on a query array of two
    axes), the absent ones on the OOV row exactly."""
    keys, queries, builds = lke_inputs
    ref, mine = builds[n_shards]
    assert mine.table.numpy().tobytes() == np.asarray(ref.table).tobytes()
    np.testing.assert_array_equal(tembed.keymod.decode(mine.keys), keys)
    assert (mine.index is None) == (n_shards > 1) and (mine.sharded is None) == (n_shards == 1)
    present = np.isin(queries, keys)
    q2 = queries.reshape(2, -1)
    for rb, tb in LKE_BACKENDS:
        want_r = np.asarray(ref.translate(queries, backend=rb))
        np.testing.assert_array_equal(mine.translate(queries, backend=tb).numpy(), want_r,
                                      err_msg=tb)
        np.testing.assert_array_equal(want_r, np.searchsorted(keys, queries, side="right") - 1)
        got = mine.lookup(q2, backend=tb).numpy()
        assert got.shape == (2, len(queries) // 2, 8)
        np.testing.assert_array_equal(got, np.asarray(ref.lookup(q2, backend=rb)), err_msg=tb)
        flat = got.reshape(-1, 8)
        np.testing.assert_array_equal(flat[~present], np.broadcast_to(
            mine.table[-1].numpy(), flat[~present].shape))
        np.testing.assert_array_equal(flat[present], mine.table.numpy()[
            np.searchsorted(keys, queries[present])])


@pytest.mark.parametrize("n_shards", (1, 4))
def test_learned_keyed_embedding_kernel_path_counts_no_launch_on_cpu(lke_inputs, n_shards):
    """On CPU tensors the kernel wrappers run their twins and count no
    launch; the index leaves equal the reference's (the RMI's ``b`` is
    ``max(2, V // 128)`` in both)."""
    keys, queries, builds = lke_inputs
    ref, lke = builds[n_shards]
    r_index, t_index = ((ref.index, lke.index) if n_shards == 1
                        else (ref.sharded.index, lke.sharded.index))
    mine = t_index.to_numpy()
    assert set(mine) == set(r_index.arrays)
    for k, v in r_index.arrays.items():
        np.testing.assert_array_equal(mine[k], np.asarray(v), err_msg=k)
    kernels.reset_launches()
    lke.lookup(queries)
    assert sum(kernels.launches().values()) == 0


# -- the mega-table lookup on 4 gloo ranks against the reference on 4 host devices --------

REF_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax
from jax.sharding import AxisType
import repro
from repro import configs
from repro.dist.sharding import ShardingCtx
from repro.models import embedding, recsys

work = sys.argv[1]
spec = json.load(open(os.path.join(work, "emb_cases.json")))
data = dict(np.load(os.path.join(work, spec["arrays"])))
assert len(jax.devices()) == 4
mesh = jax.make_mesh((1, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for case in spec["cases"]:
    if not case.get("reference", True):
        continue
    ctx = ShardingCtx(mesh=mesh, profile=case["profile"])
    if "score" in case:
        s = case["score"]
        cfg = dataclasses.replace(configs.get(s["arch"], reduced=True).config,
                                  lookup_mode=case["mode"])
        params = recsys.init(jax.random.key(s["seed"]), cfg)
        batch = {k: data[v] for k, v in s["batch"].items()}
        got = jax.jit(lambda p, b: recsys.score_fn(p, b, cfg, ctx))(params, batch)
    else:
        got = jax.jit(lambda t, i: embedding.sharded_lookup(
            t, i, ctx, mode=case["mode"], cap_factor=case["cap_factor"]))(
            data[case["table"]], data[case["ids"]])
    out[case["name"]] = np.asarray(got)
np.savez(os.path.join(work, "emb_ref.npz"), **out)
print("REF OK")
"""


def _rank_cases(work: Path) -> list:
    """The lookup cases: a 4,096 x 8 table; random ids, a skewed batch
    (every id on the last shard) and a ragged batch of 15 rows, in
    ``"a2a"`` at 4.0 and 2.0 and ``"allreduce"``, on the recsys profile
    (``flat_dp``: each rank exchanges a quarter of the batch) and
    ``tp_fsdp`` (dp = 1: every rank the whole batch); and the reduced
    wide & deep's ``score_fn`` on ``serve_p99``'s batch in both modes."""
    rng = np.random.default_rng(13)
    spec = tconfigs.get("wide-deep", reduced=True)
    torch.save(_params(rconfigs.get("wide-deep", reduced=True).config, 7)[1],
               work / "wide_deep.pt")
    batch = tsteps.make_inputs(spec, _cell(spec, "serve_p99"), np.random.default_rng(7),
                               device="cpu")
    arrays = {
        "table": rng.normal(size=(4096, 8)).astype(np.float32),
        "ids": rng.integers(0, 4096, (64, 6)).astype(np.int32),
        "skew": rng.integers(3072, 4096, (64, 6)).astype(np.int32),
        "ragged": rng.integers(0, 4096, (15, 6)).astype(np.int32),
        "wd_sparse": batch["sparse"].numpy(),
    }
    np.savez(work / "emb_arrays.npz", **arrays)
    mesh = {"mesh": [1, 4]}
    cases = []
    for profile in ("flat_dp", "tp_fsdp"):
        for ids, mode, cap in (("ids", "a2a", 4.0), ("ids", "allreduce", 2.0),
                               ("skew", "a2a", 2.0), ("skew", "allreduce", 2.0)):
            cases.append({**mesh, "name": f"{profile}/{ids}/{mode}@{cap}", "profile": profile,
                          "table": "table", "ids": ids, "mode": mode, "cap_factor": cap})
        for mode in ("a2a", "allreduce"):
            cases.append({**mesh, "name": f"{profile}/score/{mode}", "profile": profile,
                          "mode": mode, "score": {"arch": "wide-deep", "seed": 7,
                                                  "params": "wide_deep.pt",
                                                  "batch": {"sparse": "wd_sparse"}}})
    # a ragged batch: the port pads it itself (the reference cannot cut a
    # sharded a2a answer on this JAX: ROADMAP queue 3), held to the gather
    cases.append({**mesh, "name": "flat_dp/ragged/a2a@4.0", "profile": "flat_dp",
                  "table": "table", "ids": "ragged", "mode": "a2a", "cap_factor": 4.0,
                  "reference": False})
    (work / "emb_cases.json").write_text(json.dumps({"arrays": "emb_arrays.npz",
                                                     "cases": cases}))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case once: the reference in a subprocess on 4 forced host
    devices and, at the same time, the port on 4 spawned gloo ranks.
    Returns the inputs, the cases, the reference's answers and each
    rank's."""
    work = tmp_path_factory.mktemp("embedding_ranks")
    cases = _rank_cases(work)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(embedding_rank_cases, 4, work, str(work), "cpu")
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "REF OK" in out, err[-4000:]
    with np.load(work / "emb_arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    with np.load(work / "emb_ref.npz") as z:
        want = {k: z[k] for k in z.files}
    got = []
    for rank in range(4):
        with np.load(work / f"emb_out{rank}.npz") as z:
            got.append({k: z[k] for k in z.files})
    return arrays, cases, want, got


def _host_drop_model(ids: np.ndarray, n_shards: int, rows_per: int, dp: int,
                     cap_factor: float) -> np.ndarray:
    """Which ids the a2a exchange drops: each dp slice's flat ids sorted
    stably by owner, the first ``cap`` of each (slice, owner) kept."""
    b_loc = ids.shape[0] // dp
    dropped = np.zeros(ids.shape, dtype=bool)
    for src in range(dp):
        flat = ids[src * b_loc:(src + 1) * b_loc].reshape(-1)
        cap = max(1, int(-(-cap_factor * len(flat) // n_shards)))
        owner = np.clip(flat // rows_per, 0, n_shards - 1)
        order = np.argsort(owner, kind="stable")
        pos = np.arange(len(flat)) - np.searchsorted(owner[order], owner[order], side="left")
        d = np.zeros(len(flat), dtype=bool)
        d[order[pos >= cap]] = True
        dropped[src * b_loc:(src + 1) * b_loc] = d.reshape(b_loc, -1)
    return dropped


def test_lookup_on_ranks_matches_reference(ranks):
    """Every case on every rank: rows equal to the reference's bit for bit
    (wide & deep's logits within ``TOL``); ids
    within capacity read their rows; the skewed ``"a2a"`` batches at 2.0
    give zero vectors exactly on the host model's drop set (a quarter of
    the batch a source under ``flat_dp``, the whole batch under
    ``tp_fsdp``), ``"allreduce"`` and 4.0 drop nothing."""
    arrays, cases, want, got = ranks
    table = arrays["table"]
    for case in cases:
        name = case["name"]
        for rank in range(4):
            out = got[rank][name]
            if "score" in case:  # logits: MLP sums in another order
                np.testing.assert_allclose(out, want[name], atol=TOL, rtol=TOL, err_msg=name)
                continue
            if case.get("reference", True):
                np.testing.assert_array_equal(out, want[name], err_msg=f"rank {rank} {name}")
            ids = arrays[case["ids"]]
            dropped = np.zeros(ids.shape, dtype=bool)
            if case["mode"] == "a2a":
                dp = 4 if case["profile"] == "flat_dp" else 1
                pad = (-ids.shape[0]) % dp
                padded = np.concatenate([ids, np.zeros((pad, ids.shape[1]), ids.dtype)])
                dropped = _host_drop_model(padded, 4, 1024, dp, case["cap_factor"])[:len(ids)]
            assert dropped.any() == (case["ids"] == "skew" and case["mode"] == "a2a"
                                     and case["cap_factor"] < 4), name
            np.testing.assert_array_equal(out[dropped], 0, err_msg=name)
            np.testing.assert_array_equal(out[~dropped], table[ids][~dropped], err_msg=name)


def test_score_on_ranks_matches_one_rank(ranks):
    """Wide & deep's ``score_fn`` on 4 ranks' row shards (both modes, both
    profiles) equals the port's one-rank score on the whole table."""
    arrays, cases, want, got = ranks
    cfg = tconfigs.get("wide-deep", reduced=True).config
    params = _params(rconfigs.get("wide-deep", reduced=True).config, 7)[1]
    one = tr.score_fn(params, {"sparse": torch.from_numpy(arrays["wd_sparse"])}, cfg).numpy()
    for case in cases:
        if "score" in case:
            for rank in range(4):
                np.testing.assert_allclose(got[rank][case["name"]], one, atol=TOL, rtol=TOL)
