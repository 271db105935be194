"""Decode under a mesh, held on the CPU: the port's placed ``decode_step``
and ``DecodeEngine(ctx=...)`` over a (2, 2) mesh of 4 spawned gloo ranks
(``test_torch_gpu.decode_rank_cases``) against the reference's jitted
``decode_step`` and ``DecodeEngine(params, cfg, ctx)`` on the same mesh of
4 forced host devices, and against the port's one-rank step.

Once for the module (fixture ``runs``), side by side: the reference in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, a mesh
of ``AxisType.Auto`` axes: on the ``Explicit`` axes ``jax.make_mesh``
gives by default its sharding constraints refuse every config), the 4
port ranks, and here the port's one-rank steps.  Every run starts from
the same seeded parameters (the port's ``transformer.init``, carried to
the reference leaf by leaf), cache and tokens, in f32, and takes 3 steps.

Layouts (``CASES``): reduced qwen2-0.5b under the default rules (the
cache on ``dp`` only; the kernel on each rank's query heads and their one
KV head) from ``pos = 0``; under ``seqm`` -> ``model`` (the sequence split
over the ``tp`` ranks, their blocks combined by their log-sum-exp),
crossing a block boundary; under ``long_500k``'s layout (``seq_shard``,
``sp`` -> ``(data, model)``: one row, the sequence over all 4 ranks),
clamping ``pos >= max_seq``; reduced granite-3-8b under ``seqm`` with a
ragged batch of 3 over ``dp`` 2 (the rows stay whole); reduced
moonshot-v1-16b-a3b (8 experts over ``ep``, 4 KV heads split over
``tp``), under the default rules and under ``seqm``; and qwen2-0.5b under
the serving layout (``seqm``, ``fsdp`` on no axis: the weights held
whole over ``dp``, split over ``tp``).

The reference's mesh step drops the write of a clamped position where the
sequence is split (``qwen-sp``'s third step, ``pos = max_seq``: its
``dynamic_update_slice`` on the ``sp``-sharded cache leaves position
``max_seq - 1`` as it was, where on one device it overwrites it, ROADMAP
queue 3).  The port clamps as on one device: that case's last step and
its cache are held to the reference's jitted step on one device
(``single_device_ctx``), and the test pins the mesh step's difference.

Tolerance: logits and cache blocks within ``TOL`` (1e-5) of the largest
magnitude of the value they are held to (f32; the tensor-parallel sums,
the split softmax and the vocabulary-parallel embedding add in other
orders).  The MoE's one-rank step runs each ``dp`` shard's rows on their
own, so each routes its tokens at the shard's capacity, as a rank of the
mesh (and the reference's ``shard_map``) does.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.dist.sharding import AbstractMesh, ShardingCtx, _rules_for
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tt
from repro_torch.serve import DecodeEngine, Request
from test_torch_gpu import decode_rank_cases, run_ranks

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = [2, 2]
TOL = 1e-5
N_STEPS = 3
SEQM = {"seqm": ["model"]}
#: name -> (arch, extra rules, seq_shard, batch, max_seq, first pos)
CASES = {
    "qwen-dp": ("qwen2-0.5b", {}, False, 4, 32, 0),
    "qwen-seqm": ("qwen2-0.5b", SEQM, False, 4, 32, 15),
    "qwen-sp": ("qwen2-0.5b", {"sp": ["data", "model"]}, True, 1, 32, 30),
    "granite-seqm": ("granite-3-8b", SEQM, False, 3, 32, 6),
    "moonshot-dp": ("moonshot-v1-16b-a3b", {}, False, 4, 32, 9),
    "moonshot-seqm": ("moonshot-v1-16b-a3b", SEQM, False, 4, 32, 14),
    "qwen-serve": ("qwen2-0.5b", dict(SEQM, fsdp=[]), False, 4, 32, 7),
}
#: the cases whose last step clamps ``pos`` on a split sequence: held to
#: the reference on one device there (module docstring)
CLAMPED = ("qwen-sp",)
#: the engine case: qwen2-0.5b under seqm, 4 slots of 32 positions
ENGINE = {"arch": "qwen2-0.5b", "rules": SEQM, "slots": 4, "max_seq": 32, "max_new": 4,
          "prompts": [[5, 17, 200], [3], [250, 1], [9, 9, 9, 9], [77, 12]]}

REF_SCRIPT = r'''
import dataclasses, json, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import configs
from repro.dist.sharding import ShardingCtx, _rules_for, single_device_ctx
from repro.launch import steps
from repro.models import transformer as rt
from repro.serve import engine as rengine

work, job = sys.argv[1], json.loads(sys.argv[2])
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
leaves = jax.tree_util.tree_leaves


def setup(arch, rules, name):
    cfg = dataclasses.replace(configs.get(arch, reduced=True).config, dtype="float32")
    ctx = ShardingCtx(mesh=mesh, profile="tp_fsdp",
                      rules=dict(_rules_for("tp_fsdp", ("data", "model")), **rules))
    data = np.load(f"{work}/{name}.npz")
    tmpl = jax.eval_shape(lambda k: rt.init(k, cfg), jax.random.key(0))
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tmpl), [
        jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves(tmpl)))])
    return cfg, ctx, data, tmpl, params


out = {}
for c in job["cases"]:
    cfg, ctx, data, tmpl, params = setup(c["arch"], c["rules"], c["name"])
    ss = c["seq_shard"]
    p_sh = steps.fit_tree(tmpl, steps.state_shardings(tmpl, "lm", ctx), mesh)
    cache = {"k": data["k"], "v": data["v"]}
    c_sh = steps.fit_tree(cache, {k: ctx.sharding(*v)
                                  for k, v in rt.cache_logical_axes(ss).items()}, mesh)
    t_sh = steps.fit_sharding(data["tokens"].shape[1:], ctx.sharding(*((None, None) if ss else
                                                                      ("dp", None))), mesh)
    rep = ctx.sharding()
    fn = jax.jit(lambda p, kv, t, pos: rt.decode_step(p, kv, t, pos, cfg, ctx, seq_shard=ss),
                 in_shardings=(p_sh, c_sh, t_sh, rep))
    logits = []
    for i in range(data["tokens"].shape[0]):
        lg, cache = fn(params, cache, jnp.asarray(data["tokens"][i]),
                       jnp.int32(c["pos0"] + i))
        logits.append(np.asarray(lg))
        cache = {k: np.asarray(v) for k, v in cache.items()}
    out[c["name"]] = {"logits": np.stack(logits), "cache": cache,
                      "shard_shape": list(c_sh["k"].shard_shape(cache["k"].shape))}
    if c["name"] in job["single"]:  # the same steps on one device
        one = single_device_ctx()
        fn = jax.jit(lambda p, kv, t, pos: rt.decode_step(p, kv, t, pos, cfg, one,
                                                          seq_shard=ss))
        cache, logits = {"k": data["k"], "v": data["v"]}, []
        for i in range(data["tokens"].shape[0]):
            lg, cache = fn(params, cache, jnp.asarray(data["tokens"][i]),
                           jnp.int32(c["pos0"] + i))
            logits.append(np.asarray(lg))
        out[c["name"]]["single"] = {"logits": np.stack(logits),
                                    "cache": {k: np.asarray(v) for k, v in cache.items()}}
e = job["engine"]
cfg, ctx, _, _, params = setup(e["arch"], e["rules"], "engine")
eng = rengine.DecodeEngine(params, cfg, ctx, batch_slots=e["slots"], max_seq=e["max_seq"])
reqs = [rengine.Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=e["max_new"])
        for i, p in enumerate(e["prompts"])]
for r in reqs:
    eng.submit(r)
out["engine"] = {"ticks": eng.run_until_drained(), "tokens": [r.out_tokens for r in reqs]}
with open(f"{work}/ref.pkl", "wb") as f:
    pickle.dump(out, f)
print("REF OK")
'''


def _cfg(arch: str):
    return dataclasses.replace(tconfigs.get(arch, reduced=True).config, dtype="float32")


def _inputs(name: str):
    """The case's seeded parameters (the port's ``init``), whole cache
    (normal values) and ``N_STEPS`` batches of tokens."""
    arch, _, _, b, s, _ = CASES[name]
    cfg = _cfg(arch)
    params = tt.init(torch.Generator().manual_seed(7), cfg)
    rng = np.random.default_rng(11 + list(CASES).index(name))
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    cache = {k: torch.from_numpy(rng.normal(size=shape).astype(np.float32)) for k in ("k", "v")}
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (N_STEPS, b, 1)).astype(np.int32))
    return cfg, params, cache, tokens


def _one_rank(name: str):
    """The port's one-rank steps on the whole cache (an MoE's rows a ``dp``
    shard at a time, as the mesh routes them); the logits and the cache."""
    cfg, params, cache, tokens = _inputs(name)
    _, _, _, b, _, pos0 = CASES[name]
    parts = 2 if cfg.moe and b % MESH[0] == 0 else 1
    rows = b // parts
    logits = []
    for i in range(N_STEPS):
        step = []
        for j in range(parts):
            part = {k: v[:, j * rows:(j + 1) * rows] for k, v in cache.items()}
            lg, part = tt.decode_step(params, part, tokens[i, j * rows:(j + 1) * rows],
                                      pos0 + i, cfg)
            for k in cache:
                cache[k][:, j * rows:(j + 1) * rows] = part[k]
            step.append(lg)
        logits.append(torch.cat(step))
    return torch.stack(logits), cache


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 4 ranks and the reference's subprocess side by side, and
    the one-rank steps here.  Returns ``(ref, got_by_rank, one)``."""
    work = tmp_path_factory.mktemp("decode_mesh")
    cases, ref_cases = [], []
    for name, (arch, rules, ss, b, s, pos0) in CASES.items():
        cfg, params, cache, tokens = _inputs(name)
        torch.save({"params": params, "cache": cache, "tokens": tokens}, work / f"{name}.pt")
        np.savez(work / f"{name}.npz", k=cache["k"].numpy(), v=cache["v"].numpy(),
                 tokens=tokens.numpy(),
                 **{f"leaf_{i}": t.numpy() for i, t in enumerate(tree.leaves(params))})
        case = dict(name=name, kind="steps", arch=arch, rules=rules, seq_shard=ss, pos0=pos0,
                    config={"dtype": "float32"}, mesh=MESH)
        cases.append(case)
        ref_cases.append(case)
    cfg = _cfg(ENGINE["arch"])
    params = tt.init(torch.Generator().manual_seed(8), cfg)
    torch.save({"params": params}, work / "engine.pt")
    np.savez(work / "engine.npz", **{f"leaf_{i}": t.numpy()
                                     for i, t in enumerate(tree.leaves(params))})
    cases.append(dict(ENGINE, name="engine", kind="engine", config={"dtype": "float32"},
                      mesh=MESH))
    (work / "decode_cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    job = json.dumps({"cases": ref_cases, "engine": ENGINE, "single": CLAMPED})
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(work), job], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err = []

    def spawn():
        try:
            run_ranks(decode_rank_cases, 4, work, str(work), "cpu", timeout=600)
        except BaseException as e:  # raised below
            err.append(e)

    th = threading.Thread(target=spawn)
    th.start()
    try:
        one = {name: _one_rank(name) for name in CASES}
        eng = DecodeEngine(params, cfg, batch_slots=ENGINE["slots"], max_seq=ENGINE["max_seq"])
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=ENGINE["max_new"])
                for i, p in enumerate(ENGINE["prompts"])]
        for r in reqs:
            eng.submit(r)
        one["engine"] = {"ticks": eng.run_until_drained(), "tokens": [r.out_tokens for r in reqs]}
    finally:
        th.join()
        out_s, err_s = ref.communicate(timeout=600)
    if err:
        raise err[0]
    assert ref.returncode == 0 and "REF OK" in out_s, err_s[-4000:]
    with open(work / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    got = [torch.load(work / f"decode_out{r}.pt", weights_only=False) for r in range(4)]
    return want, got, one


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=TOL * np.abs(want).max(),
                               err_msg=what)


def _block(whole: np.ndarray, name: str, coord) -> np.ndarray:
    """The rank at ``coord``'s block of a whole cache under the case's
    placement."""
    arch, rules, ss, b, s, _ = CASES[name]
    mesh = AbstractMesh(tuple(MESH), ("data", "model"))
    ctx = ShardingCtx(mesh=mesh, rules=dict(_rules_for("tp_fsdp", ("data", "model")), **rules))
    plan = tt.cache_placement(_cfg(arch), ctx, b, s, ss)
    t = torch.from_numpy(np.asarray(whole))
    return (t if plan is None else plan.sharding.local_block(t, coord)).numpy()


def _reference(want: dict, name: str) -> dict:
    """The reference's logits and cache the case is held to: its mesh
    steps, the clamped step of a ``CLAMPED`` case on one device."""
    ref = want[name]
    if name not in CLAMPED:
        return ref
    return {"logits": np.concatenate([ref["logits"][:-1], ref["single"]["logits"][-1:]]),
            "cache": ref["single"]["cache"]}


@pytest.mark.parametrize("name", list(CASES))
def test_placed_decode_logits_match_reference_mesh_and_one_rank(runs, name):
    """3 placed steps: every rank returns the same whole logits, within
    ``TOL`` of the reference's jitted ``decode_step`` on its (2, 2) mesh
    (on one device for the clamped step of a ``CLAMPED`` case) and of the
    port's one-rank step."""
    want, got, one = runs
    mine = got[0][name]["logits"]
    for g in got[1:]:
        assert torch.equal(g[name]["logits"], mine)
    ref = _reference(want, name)["logits"]
    assert mine.shape == ref.shape
    _close(mine.numpy(), ref, f"{name} logits vs the reference's step")
    _close(mine.numpy(), one[name][0].numpy(), f"{name} logits vs the one-rank step")


def test_reference_mesh_step_drops_the_clamped_write(runs):
    """The reference's fault the port does not copy: at ``pos = max_seq``
    on an ``sp``-split cache its mesh step leaves position ``max_seq - 1``
    as the step before wrote it, and its logits leave the one-device
    step's, which the earlier steps match."""
    want, _, _ = runs
    for name in CLAMPED:
        ref, single = want[name], want[name]["single"]
        _close(ref["logits"][:-1], single["logits"][:-1], f"{name} earlier steps")
        assert np.abs(ref["logits"][-1] - single["logits"][-1]).max() > 100 * TOL * np.abs(
            single["logits"][-1]).max()
        assert not np.array_equal(ref["cache"]["k"][:, :, -1], single["cache"]["k"][:, :, -1])
        _close(ref["cache"]["k"][:, :, :-1], single["cache"]["k"][:, :, :-1], f"{name} cache")


@pytest.mark.parametrize("name", list(CASES))
def test_placed_cache_blocks_match_reference_shards(runs, name):
    """Each rank's cache block has the reference's shard shape exactly and,
    after the 3 steps, the values of the same block of the reference's
    cache and of the one-rank cache (the new rows written by the rank
    whose sequence block holds each position); ``gather_cache`` gives
    every rank the same whole cache, each block in its place."""
    want, got, one = runs
    for r, g in enumerate(got):
        res = g[name]
        assert res["shape"] == want[name]["shard_shape"], (name, r)
        for k in ("k", "v"):  # gather_cache puts the blocks back together
            assert torch.equal(res["whole"][k], got[0][name]["whole"][k])
            assert torch.equal(torch.from_numpy(_block(res["whole"][k].numpy(), name,
                                                       res["coord"])), res["cache"][k])
        for k in ("k", "v"):
            _close(res["cache"][k].numpy(), _block(_reference(want, name)["cache"][k], name,
                                                   res["coord"]),
                   f"{name} rank {r} cache {k} vs the reference's")
            _close(res["cache"][k].numpy(), _block(one[name][1][k].numpy(), name, res["coord"]),
                   f"{name} rank {r} cache {k} vs the one-rank cache")


def test_placed_layouts_split_what_the_rules_name(runs):
    """The layouts differ as the rules say: the default rules split only
    the batch, ``seqm`` also the sequence over ``model``, ``sp`` the whole
    sequence over the 4 ranks, and a batch ``dp`` does not divide stays
    whole."""
    _, got, _ = runs
    shapes = {name: got[0][name]["shape"] for name in CASES}
    assert shapes["qwen-dp"][1:3] == [2, 32]
    assert shapes["qwen-seqm"][1:3] == [2, 16]
    assert shapes["qwen-sp"][1:3] == [1, 8]
    assert shapes["granite-seqm"][1:3] == [3, 16]


def test_placed_engine_serves_the_reference_tokens(runs):
    """``DecodeEngine(ctx=...)`` on the 4 ranks (seqm: each rank a batch
    half and a sequence half of the cache) serves the reference engine's
    tokens on its mesh, and the one-rank engine's, with as many ticks."""
    want, got, one = runs
    for g in got:
        assert g["engine"]["tokens"] == want["engine"]["tokens"] == one["engine"]["tokens"]
        assert g["engine"]["ticks"] == want["engine"]["ticks"] == one["engine"]["ticks"]
        assert g["engine"]["shape"][1:3] == [2, 16]


def test_decode_cell_builds_under_a_placed_context():
    """Both LM ``decode`` cells build under a placed (2, 2) context: the
    bundle carries the cache's placement, as the reference's carries its
    ``cache_shardings``; no context gives no placement."""
    spec = tconfigs.get("qwen2-0.5b", reduced=True)
    rules = dict(_rules_for("tp_fsdp", ("data", "model")), seqm=("model",), sp=("data", "model"))
    ctx = ShardingCtx(mesh=AbstractMesh((2, 2), ("data", "model")), rules=rules)
    for cell in (c for c in spec.shapes if c.kind == "decode"):
        bundle = tsteps.build_step(spec, cell, ctx)
        b, s = cell.dims["global_batch"], cell.dims["seq_len"]
        cp = bundle.cache_placement
        if cell.dims.get("seq_shard"):
            assert cp.block == (2, b, s // 4, 1, 16)
        else:
            assert cp.block == (2, b // 2, s // 2, 1, 16)
        assert tsteps.build_step(spec, cell).cache_placement is None


def test_whole_cache_under_a_placed_context_is_refused():
    """A placed step refuses a whole cache where its block is expected."""
    cfg = _cfg("qwen2-0.5b")
    rules = dict(_rules_for("tp_fsdp", ("data", "model")), seqm=("model",))
    from repro_torch.dist.sharding import CommLedger

    ctx = ShardingCtx(mesh=AbstractMesh((2, 2), ("data", "model"), ledger=CommLedger()),
                      rules=rules)
    params = tt.init(torch.Generator().manual_seed(0), cfg, ctx)
    cache = tt.init_cache(cfg, 4, 32, device="cpu")
    with pytest.raises(ValueError, match="block"):
        tt.decode_step(params, cache, torch.zeros((4, 1), dtype=torch.int32), 0, cfg, ctx,
                       max_seq=32)
    block = tt.init_cache(cfg, 4, 32, device="cpu", ctx=ctx)
    assert tuple(block["k"].shape) == (2, 2, 16, 1, 16)


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_plain_attention_blocks_combine_to_the_whole(n_blocks):
    """``backend="ref"`` on a cache split by sequence: the reference's
    plain math with ``return_lse`` on each block (an empty block weighs 0
    through its ``NEG_INF``), combined, == its call on the whole cache
    (f32), as the kernel's blocks do (``test_torch_scaffold_kernels``)."""
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(5)
    b, hq, hkv, d, s = 4, 8, 2, 16, 64
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    kv_len = torch.tensor([1, s // 4 + 1, s - 1, s], dtype=torch.int32)
    s_loc = s // n_blocks
    outs, lses = [], []
    for i in range(n_blocks):
        blk = slice(i * s_loc, (i + 1) * s_loc)
        n = torch.clamp(kv_len - i * s_loc, 0, s_loc)
        o, lse = tl.decode_attention(q, k[:, blk], v[:, blk], n, backend="ref", return_lse=True)
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))[..., None]
    got = (w * torch.stack(outs)).sum(dim=0) / w.sum(dim=0)
    want = tl.decode_attention(q, k, v, kv_len, backend="ref")
    _close(got.numpy(), want.numpy(), f"{n_blocks} plain blocks")
