"""The port's MoE decoder (``models/moe.py`` and the transformer's MoE
path) held against the JAX reference on the CPU, on the reduced
moonshot-v1-16b-a3b (8 experts, top 2, one shared expert) and
qwen3-moe-235b-a22b (8 experts, top 2, no shared expert, GQA 4/1).

The same weights (the reference's ``transformer.init``, carried across
with ``params_from_numpy``) and the same numpy inputs go through both, in
f32.  Tolerances: 2e-5 absolute and relative on the block outputs and the
logits (f32 sums in another order); the dispatched tokens and the
capacity drops must be equal.  The reference runs ``moe_ffn`` under
``single_device_ctx()``.

The reference's ``decode_step`` on an MoE config returns caches with an
explicit mesh sharding that its next step's ``dynamic_update_slice``
refuses (``ShardingTypeError``; ROADMAP queue 3).  The tests take the
reference's caches through numpy between its steps (:class:`_RefEngine`
for its engine), which changes no value.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import obs as robs
from repro.configs import get as rget
from repro.core import as_table, true_ranks
from repro.dist.sharding import single_device_ctx
from repro.index import RMISpec as RRMI
from repro.models import moe as rmoe
from repro.models import transformer as rt
from repro.serve import engine as rengine
from repro.serve.hotcache import HotKeyCache as RCache
from repro.tune import RebuildPolicy as RPolicy
from repro.tune import TunedTier as RTier

from repro_torch import obs as tobs
from repro_torch.configs import get as tget
from repro_torch.index import RMISpec as TRMI
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.serve import DecodeEngine, HotKeyCache, Request
from repro_torch.tune import RebuildPolicy as TPolicy
from repro_torch.tune import TunedTier as TTier

TOL = 2e-5
MOE_ARCHS = ("moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b")
_NAMES = itertools.count()


def _cfgs(arch, **changes):
    r = dataclasses.replace(rget(arch, reduced=True).config, dtype="float32", **changes)
    t = dataclasses.replace(tget(arch, reduced=True).config, dtype="float32", **changes)
    return r, t


def _params(cfg_r, cfg_t, seed=0):
    rp = rt.init(jax.random.key(seed), cfg_r)
    return rp, tt.params_from_numpy(jax.tree.map(np.asarray, rp), cfg_t, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _host_cache(step):
    def run(*args):
        logits, cache = step(*args)
        return logits, jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), cache)
    return run


class _RefEngine(rengine.DecodeEngine):
    """The reference engine with its caches taken through numpy after
    every step (the module docstring says why)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._decode = _host_cache(self._decode)
        self._prefill_tok = _host_cache(self._prefill_tok)


def _layer_moe(rp, layer=0):
    lp = {k: v[layer] for k, v in rp["layers"]["moe"].items()}
    return lp, {k: torch.from_numpy(np.array(v)) for k, v in lp.items()}


#: (tokens, changes to the config, router weights zeroed): a decode batch;
#: a batch past the capacity (every expert slot contested); a zero router,
#: where every probability ties and every token picks experts 0..k-1; a
#: tight capacity factor; one token
MOE_CASES = {
    "decode8": (8, {}, False),
    "batch33": (33, {}, False),
    "zero_router": (9, {}, True),
    "tight": (16, {"capacity_factor": 0.3}, False),
    "one_token": (1, {}, False),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, case):
    t, changes, zero = MOE_CASES[case]
    cfg_r, cfg_t = _cfgs(arch, **changes)
    rp, _ = _params(cfg_r, cfg_t)
    lp_r, lp_t = _layer_moe(rp)
    if zero:
        lp_r["router"] = jnp.zeros_like(lp_r["router"])
        lp_t["router"] = torch.zeros_like(lp_t["router"])
    x = np.random.default_rng(7).normal(size=(t, cfg_r.d_model)).astype(np.float32)
    ctx = single_device_ctx()
    want = np.asarray(jax.jit(lambda x, lp: rmoe.moe_ffn(x, lp, cfg_r, ctx))(jnp.asarray(x), lp_r))
    got = tmoe.moe_ffn(torch.from_numpy(x), lp_t, cfg_t)
    assert got.dtype == torch.float32 and got.shape == (t, cfg_t.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dispatch_local_matches_reference(arch, case):
    """The dispatched tokens ``xe`` are equal, and so are the kept (token,
    k) pairs: ``combine`` of all-ones expert outputs gives each token the
    sum of its kept routing weights, which is below 1 exactly where a pair
    was dropped."""
    t, changes, zero = MOE_CASES[case]
    cfg_r, cfg_t = _cfgs(arch, **changes)
    rp, _ = _params(cfg_r, cfg_t, seed=1)
    router = np.array(rp["layers"]["moe"]["router"][0])
    if zero:
        router[:] = 0
    rng = np.random.default_rng(8)
    x = rng.normal(size=(t, cfg_r.d_model)).astype(np.float32)
    e = cfg_r.n_experts
    cap = tmoe.capacity_of(t, cfg_t)
    assert cap == max(1, int(np.ceil(t * cfg_r.top_k / e * cfg_r.capacity_factor)))
    kw = dict(e_loc=e, col=0, n_experts=e, top_k=cfg_r.top_k, capacity=cap)
    ones = np.ones((e, cap, cfg_r.d_model), np.float32)
    ye = rng.normal(size=(e, cap, cfg_r.d_model)).astype(np.float32)

    @jax.jit
    def reference(x, router, ones, ye):
        xe, combine = rmoe._dispatch_local(x, router, dtype=jnp.float32, **kw)
        return xe, combine(ones), combine(ye)

    xe_r, kept_r, out_r = (np.asarray(a) for a in reference(
        jnp.asarray(x), jnp.asarray(router), jnp.asarray(ones), jnp.asarray(ye)))
    xe_t, comb_t = tmoe._dispatch_local(torch.from_numpy(x), torch.from_numpy(router),
                                        dtype=torch.float32, **kw)
    np.testing.assert_array_equal(xe_t.numpy(), xe_r)
    kept_t = comb_t(torch.from_numpy(ones)).numpy()
    np.testing.assert_allclose(kept_t, kept_r, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(comb_t(torch.from_numpy(ye)).numpy(), out_r, rtol=TOL, atol=TOL)
    dropped = kept_t[:, 0] < 1 - 1e-5
    if case in ("zero_router", "batch33", "tight"):
        assert dropped.any(), "the case must overflow an expert's capacity"
    if case == "zero_router":  # ties: experts 0..k-1 for every token, the first cap kept
        assert not dropped[:cap].any() and dropped[cap:].all()


def test_top_k_breaks_ties_like_lax():
    rng = np.random.default_rng(9)
    p = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4  # many ties
    for k in (1, 2, 6, 16):
        vr, ir = lax.top_k(jnp.asarray(p), k)
        vt, it = tmoe._top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ir))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vr))


def test_capacity_at_the_published_widths():
    """moonshot's decode batch of 8 slots: ceil(8 * 6 / 64 * 1.25) = 1, so
    any expert picked twice drops a pair."""
    for arch in MOE_ARCHS:
        cr, ct = rget(arch).config, tget(arch).config
        assert ct.capacity_factor == cr.capacity_factor == 1.25
        for t in (1, 8, 128, 1000):
            want = max(1, int(np.ceil(t * cr.top_k / cr.n_experts * cr.capacity_factor)))
            assert tmoe.capacity_of(t, ct) == want
    assert tmoe.capacity_of(8, tget("moonshot-v1-16b-a3b").config) == 1


@pytest.mark.parametrize("attn", ["kernel", "ref"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_step_matches_reference(arch, attn):
    """Logits and caches over 5 positions, each step fed the same random
    tokens (``"kernel"`` runs the attention kernel's twin on the CPU)."""
    cfg_r, cfg_t = _cfgs(arch)
    rp, tp = _params(cfg_r, cfg_t)
    ctx = single_device_ctx()
    b, s = 5, 16
    cache_r = rt.init_cache(cfg_r, b, s)
    cache_t = tt.init_cache(cfg_t, b, s, device="cpu")
    step_r = _host_cache(jax.jit(lambda p, c, tok, pos: rt.decode_step(p, c, tok, pos, cfg_r, ctx)))
    rng = np.random.default_rng(10)
    for pos in range(5):
        tok = rng.integers(0, cfg_r.vocab, (b, 1)).astype(np.int32)
        lr, cache_r = step_r(rp, cache_r, jnp.asarray(tok), jnp.int32(pos))
        lt, cache_t = tt.decode_step(tp, cache_t, torch.from_numpy(tok), pos, cfg_t, backend=attn)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=TOL, atol=TOL,
                                   err_msg=f"logits at pos {pos}")
        for kv in ("k", "v"):
            np.testing.assert_allclose(cache_t[kv].numpy(), np.asarray(cache_r[kv]), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_greedy_tokens_match_reference(arch):
    cfg_r, cfg_t = _cfgs(arch)
    rp, tp = _params(cfg_r, cfg_t, seed=2)
    r_eng = _RefEngine(rp, cfg_r, single_device_ctx(), batch_slots=3, max_seq=48)
    t_eng = DecodeEngine(tp, cfg_t, batch_slots=3, max_seq=48)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg_r.vocab, rng.integers(3, 8)).astype(np.int32) for _ in range(5)]
    rr = [rengine.Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for a, b in zip(rr, tr):
        r_eng.submit(a)
        t_eng.submit(b)
    assert t_eng.run_until_drained() == r_eng.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in rr]
    assert all(r.done and len(r.out_tokens) == 5 for r in tr)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_and_params_from_numpy_match_reference_tree(arch):
    """The port's ``init`` draws the reference's tree, shapes and dtypes
    (the nested ``moe`` dict, the shared expert where ``n_shared`` is set),
    and ``params_from_numpy`` carries the reference's weights across."""
    cfg_r, cfg_t = _cfgs(arch)
    rp, tp = _params(cfg_r, cfg_t)
    want, got = _leaves(jax.tree.map(np.asarray, rp)), _leaves(tp)
    assert set(got) == set(want)
    assert {"layers/moe/router", "layers/moe/wg", "layers/moe/wu", "layers/moe/wd"} <= set(got)
    assert ("layers/wg" in got) == bool(cfg_r.n_shared)
    for name, w in want.items():
        assert got[name].dtype == torch.float32 and tuple(got[name].shape) == w.shape, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    mine = _leaves(tt.init(torch.Generator().manual_seed(0), cfg_t))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: w.shape for k, w in want.items()}
    assert all(v.dtype == torch.float32 for v in mine.values())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_init_draws_a_layer_at_a_time(arch):
    """``param_dtype="bfloat16"``: every leaf in bf16, the reference's
    shapes; the stacked weights' std is 1/sqrt(fan_in) (jax.random draws
    cannot be reproduced, so only the distribution is checked)."""
    cfg_r, cfg_t = _cfgs(arch, param_dtype="bfloat16")
    want = _leaves(jax.eval_shape(lambda: rt.init(jax.random.key(0), cfg_r)))
    got = _leaves(tt.init(torch.Generator().manual_seed(1), cfg_t))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: w.shape for k, w in want.items()}
    assert all(v.dtype == torch.bfloat16 for v in got.values())
    assert all(str(w.dtype) == "bfloat16" for w in want.values())
    for name in ("layers/moe/router", "layers/moe/wg", "layers/moe/wd", "layers/wq"):
        w = got[name].float()
        std = 1.0 / np.sqrt(w.shape[-2])
        assert abs(float(w.std()) / std - 1) < 0.1, name
        assert abs(float(w.mean())) < 0.1 * std, name
        assert not torch.equal(w[0], w[1]), name  # each layer its own draw


def test_moe_engine_with_hot_cache_tier_matches_reference():
    """``DecodeEngine(params, cfg, tier=HotKeyCache(TunedTier(...)))`` on the
    reduced moonshot: keys buffered in a static tier, the ticks drive its
    refresh, cached lookups before and after.  Greedy tokens, ``serve_*``
    samples, the tier's counters and the cache's counters equal the
    reference engine's on the same weights."""
    cfg_r, cfg_t = _cfgs("moonshot-v1-16b-a3b")
    rp, tp = _params(cfg_r, cfg_t, seed=3)
    rng = np.random.default_rng(12)
    table = as_table(rng.integers(0, 2**61, size=2048, dtype=np.uint64))
    policy = dict(shard_refresh_frac=0.01, retune_frac=10.0, n_queries=128)
    rtier = RTier(table, n_shards=2, spec=RRMI(b=32), policy=RPolicy(**policy))
    ttier = TTier(table, n_shards=2, spec=TRMI(b=32), policy=TPolicy(**policy),
                  name=f"moe_engine_{next(_NAMES)}", device="cpu")
    rc, tc = RCache(rtier, capacity=64), HotKeyCache(ttier, capacity=64)
    hot = rng.choice(table, 40)
    qs = np.concatenate([rng.choice(hot, 100), rng.choice(table, 28)]).astype(np.uint64)
    for c in (rc, tc):
        c.sketch.update(hot, weight=4.0)
        c.rebuild()
    np.testing.assert_array_equal(tc.lookup(qs).numpy(), np.asarray(rc.lookup(qs)))
    new_keys = np.setdiff1d(np.unique(rng.integers(0, 2**61, size=64, dtype=np.uint64)), table)
    for tier in (rtier, ttier):
        tier._pending[0].append(new_keys)  # buffered: the engine's tick applies the policy
        tier.counters.pending += len(new_keys)
    r_eng = _RefEngine(rp, cfg_r, single_device_ctx(), batch_slots=2, max_seq=32, tier=rc)
    t_eng = DecodeEngine(tp, cfg_t, batch_slots=2, max_seq=32, tier=tc)
    prompts = [rng.integers(0, cfg_r.vocab, n).astype(np.int32) for n in (3, 5, 4)]
    rr = [rengine.Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for a, b in zip(rr, tr):
        r_eng.submit(a)
        t_eng.submit(b)
    assert t_eng.run_until_drained() == r_eng.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in rr]
    merged = np.union1d(table, new_keys)
    got = tc.lookup(qs).numpy()
    np.testing.assert_array_equal(got, np.asarray(rc.lookup(qs)))
    np.testing.assert_array_equal(got, true_ranks(merged, qs))
    mr, mt = r_eng.metrics(), t_eng.metrics()
    keys = ("ticks", "tokens_decoded", "requests_finished", "queued", "live_slots")
    assert {k: mt[k] for k in keys} == {k: mr[k] for k in keys}
    serve = [f"serve_{k}" for k in keys]
    assert ({m: tobs.sample_value(tobs.snapshot(), m, engine=t_eng.name) for m in serve}
            == {m: robs.sample_value(robs.snapshot(), m, engine=r_eng.name) for m in serve})
    tier_keys = ("n_keys", "lookups", "ingested", "shard_refreshes", "forced_restacks", "pending",
                 "retunes")
    assert {k: mt["tier"][k] for k in tier_keys} == {k: mr["tier"][k] for k in tier_keys}
    assert mt["tier"]["shard_refreshes"] + mt["tier"]["forced_restacks"] >= 1
    assert mt["tier"]["pending"] == 0
    assert mt["tier"]["hotcache"] == mr["tier"]["hotcache"]
    assert mt["tier"]["hotcache"]["stale_detected"] == 1 and mt["tier"]["hotcache"]["hits"] > 0
