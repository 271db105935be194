"""The port's LM serving path (configs, layers, ``decode_step`` and
``DecodeEngine``) held against the JAX reference on the CPU.

The same weights (the reference's ``transformer.init``, carried across
with ``params_from_numpy``) and the same numpy tokens go through both.
Tolerances:
- f32: 2e-5 absolute and relative on logits of magnitude ~5, and 1e-5 on
  the caches (f32 sums in another order: measured differences ~2e-6);
- bf16: 0.1 absolute and 0.05 relative on the logits, about three bf16
  ulps at |logit| ~ 4, and 0.0625 on the caches (both frameworks round
  every product to bf16, at different places: measured ~0.03 / 0.016).
The engine's greedy tokens must be equal.  At every step whose argmax
picks a token, the test asserts that the top-2 logit margin exceeds the
f32 tolerance, so a near-tie cannot make the comparison flaky.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist.sharding import single_device_ctx
from repro.models import layers as rlayers
from repro.models import transformer as rt
from repro.serve import engine as rengine
from repro_torch import configs as tconfigs
from repro_torch import kernels
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt
from repro_torch.serve import DecodeEngine, Request

F32_TOL = 2e-5
F32_CACHE_TOL = 1e-5
BF16_ATOL, BF16_RTOL, BF16_CACHE_TOL = 0.1, 0.05, 0.0625
LM_ARCHS = ("granite-3-8b", "minitron-8b", "qwen2-0.5b", "moonshot-v1-16b-a3b",
            "qwen3-moe-235b-a22b")


def _cfgs(dtype="float32"):
    """Reduced qwen2-0.5b (qkv_bias, GQA 4/1) in both packages."""
    r = dataclasses.replace(rconfigs.get("qwen2-0.5b", reduced=True).config, dtype=dtype)
    t = dataclasses.replace(tconfigs.get("qwen2-0.5b", reduced=True).config, dtype=dtype)
    return r, t


def _params(cfg_r, cfg_t, seed=0):
    rp = rt.init(jax.random.key(seed), cfg_r)
    if cfg_r.qkv_bias:  # non-zero biases, so the test sees them applied
        rng = np.random.default_rng(seed)
        rp["layers"] = {**rp["layers"], **{
            k: jnp.asarray(rng.normal(0, 0.1, rp["layers"][k].shape).astype(np.float32))
            for k in ("bq", "bk", "bv")}}
    return rp, tt.params_from_numpy(jax.tree.map(np.asarray, rp), cfg_t, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_lm_configs_match_reference(arch, reduced):
    r = rconfigs.get(arch, reduced=reduced)
    t = tconfigs.get(arch, reduced=reduced)
    # the port defines the fields its slices read; each equals the reference's
    mine = dataclasses.asdict(t.config)
    assert set(mine) <= set(dataclasses.asdict(r.config))
    assert mine == {name: getattr(r.config, name) for name in mine}
    assert t.config.params_count == r.config.params_count
    assert t.config.active_params_count == r.config.active_params_count
    assert (t.arch_id, t.family) == (r.arch_id, r.family)
    assert [(c.name, c.kind, c.dims) for c in t.shapes] == [(c.name, c.kind, c.dims) for c in r.shapes]


def test_registry_lists_the_lm_family_and_refuses_the_rest():
    """The registry lists every family the reference defines (recsys since
    its slice, DimeNet since the DimeNet slice) with the reference's
    specs, and refuses an unknown id."""
    recsys = ("dlrm-mlperf", "din", "wide-deep", "sasrec")
    assert tconfigs.list_archs() == sorted(LM_ARCHS + recsys + ("dimenet",))
    assert tconfigs.list_archs() == rconfigs.list_archs()
    for reduced in (False, True):
        r, t = rconfigs.get("dimenet", reduced=reduced), tconfigs.get("dimenet", reduced=reduced)
        assert dataclasses.asdict(t.config) == dataclasses.asdict(r.config)
        assert (t.arch_id, t.family) == (r.arch_id, r.family)
        assert [(c.name, c.kind, c.dims) for c in t.shapes] == [(c.name, c.kind, c.dims)
                                                               for c in r.shapes]
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get("no-such-arch")


def test_params_from_numpy_round_trips_reference_init():
    cfg_r, cfg_t = _cfgs()
    rp = rt.init(jax.random.key(0), cfg_r)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, rp), cfg_t, device="cpu")
    want, got = _leaves(jax.tree.map(np.asarray, rp)), _leaves(tp)
    assert set(got) == set(want) and {"layers/bq", "layers/bk", "layers/bv"} <= set(got)
    for name, w in want.items():
        g = got[name]
        assert g.device.type == "cpu" and g.dtype == torch.float32, name
        assert tuple(g.shape) == w.shape, name  # the (in, out) layout, stacked on layers
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the port's own init draws the same layout
    mine = _leaves(tt.init(torch.Generator().manual_seed(0), cfg_t))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: w.shape for k, w in want.items()}
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in mine.values())


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    for dt, tdt, tol in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = np.asarray(rlayers.rms_norm(jnp.asarray(x).astype(dt), jnp.asarray(w)), np.float32)
        got = tlayers.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    for seq, offset in ((5, 0), (1, 37), (1, 32767)):
        rc, rs = rlayers.rope_tables(seq, 16, 1e4, offset=offset)
        tc, ts = tlayers.rope_tables(seq, 16, 1e4, offset=offset)
        # cos/sin of angles up to ~3e4 rad: an ulp of the f32 angle is ~2e-3
        np.testing.assert_allclose(tc.numpy(), np.asarray(rc), atol=4e-3 if offset > 1000 else 1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(rs), atol=4e-3 if offset > 1000 else 1e-6)
    cos, sin = rlayers.rope_tables(5, 16, 1e4, offset=3)
    want = np.asarray(rlayers.apply_rope(jnp.asarray(x), cos, sin))
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(cos)),
                             torch.from_numpy(np.array(sin))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("attn", ["kernel", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype, attn):
    """Logits and both caches over 6 positions, each step fed the same
    random tokens; the ``"kernel"`` attention runs the kernel's twin on
    the CPU.  (The parameter is not named ``backend``: that name is the
    conftest's index-backend fixture.)"""
    cfg_r, cfg_t = _cfgs(dtype)
    rp, tp = _params(cfg_r, cfg_t)
    ctx = single_device_ctx()
    b, s = 3, 16
    cache_r = rt.init_cache(cfg_r, b, s)
    cache_t = tt.init_cache(cfg_t, b, s, device="cpu")
    rng = np.random.default_rng(4)
    f32 = dtype == "float32"
    atol, rtol = (F32_TOL, F32_TOL) if f32 else (BF16_ATOL, BF16_RTOL)
    ctol = F32_CACHE_TOL if f32 else BF16_CACHE_TOL
    for pos in range(6):
        tok = rng.integers(0, cfg_r.vocab, (b, 1)).astype(np.int32)
        lr, cache_r = rt.decode_step(rp, cache_r, jnp.asarray(tok), jnp.int32(pos), cfg_r, ctx)
        lt, cache_t = tt.decode_step(tp, cache_t, torch.from_numpy(tok), pos, cfg_t, backend=attn)
        assert lt.dtype == torch.float32 and lt.shape == (b, cfg_t.vocab)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lr), rtol=rtol, atol=atol,
                                   err_msg=f"logits at pos {pos}")
        for kv in ("k", "v"):
            np.testing.assert_allclose(cache_t[kv].float().numpy(),
                                       np.asarray(cache_r[kv], np.float32), rtol=ctol, atol=ctol,
                                       err_msg=f"{kv} cache at pos {pos}")


def _requests(n, vocab, max_new=5, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, rng.integers(3, 10)).astype(np.int32), max_new)
            for i in range(n)]


def _margin_spies(eng, margins):
    """Wrap the port engine's two step functions to record the top-2
    logit margin of every row whose argmax picks a token."""
    decode, prefill = eng._decode, eng._prefill_tok

    def top2(row):
        v = torch.topk(row, 2).values
        return float(v[0] - v[1])

    def on_decode(params, cache, tokens, pos_per_slot):
        logits, cache = decode(params, cache, tokens, pos_per_slot)
        margins.extend(top2(logits[s]) for s in range(eng.b) if eng.slot_req[s] is not None)
        return logits, cache

    def on_prefill(params, cache, tokens, pos):
        logits, cache = prefill(params, cache, tokens, pos)
        (slot,) = [s for s in range(eng.b) if eng.slot_req[s] is not None
                   and not eng.slot_req[s].out_tokens]
        if pos == len(eng.slot_req[slot].prompt) - 1:
            margins.append(top2(logits[slot]))
        return logits, cache

    eng._decode, eng._prefill_tok = on_decode, on_prefill


def test_engine_greedy_tokens_match_reference():
    cfg_r, cfg_t = _cfgs()
    rp, tp = _params(cfg_r, cfg_t, seed=1)
    ref_eng = rengine.DecodeEngine(rp, cfg_r, single_device_ctx(), batch_slots=4, max_seq=64)
    eng = DecodeEngine(tp, cfg_t, batch_slots=4, max_seq=64)
    margins = []
    _margin_spies(eng, margins)
    reqs = _requests(6, cfg_r.vocab)
    rr = [rengine.Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs]
    tr = [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in reqs]
    for a, b in zip(rr, tr):
        ref_eng.submit(a)
        eng.submit(b)
    assert eng.run_until_drained() == ref_eng.run_until_drained()
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in rr]
    assert all(r.done and len(r.out_tokens) == 5 for r in tr)
    assert len(margins) == sum(len(r.out_tokens) for r in tr)
    assert min(margins) > F32_TOL
    m = eng.metrics()
    counters = {k: m[k] for k in ("ticks", "tokens_decoded", "requests_finished", "queued",
                                  "live_slots")}
    assert counters == {"ticks": ref_eng.ticks, "tokens_decoded": ref_eng.tokens_decoded,
                        "requests_finished": 6, "queued": 0, "live_slots": 0}
    assert all(type(v) is int for v in counters.values())
    assert set(m) == set(ref_eng.metrics())  # the reference's keys, serve_* and telemetry


def test_engine_attends_through_the_kernel_wrapper(monkeypatch):
    """Every attention call of a served run, prefill and decode, goes to the
    kernel's wrapper (its twin on CPU tensors), never to the reference
    math: n_layers calls a step, as the card's launch count checks."""
    cfg_r, cfg_t = _cfgs()
    _, tp = _params(cfg_r, cfg_t, seed=3)
    calls = []
    wrapper = tlayers._kernel.decode_attention

    def spy(q, k, v, kv_len):
        calls.append(kv_len.clone())
        return wrapper(q, k, v, kv_len)

    def refuse(*args):
        raise AssertionError("the engine ran the reference attention")

    monkeypatch.setattr(tlayers._kernel, "decode_attention", spy)
    monkeypatch.setattr(tlayers, "decode_attention_plain", refuse)
    eng = DecodeEngine(tp, cfg_t, batch_slots=2, max_seq=32)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m) for i, p, m in _requests(3, cfg_t.vocab)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    steps = sum(len(r.prompt) for r in reqs) + eng.ticks
    assert all(r.done and len(r.out_tokens) == 5 for r in reqs)
    assert len(calls) == cfg_t.n_layers * steps
    assert all(c.dtype == torch.int32 and c.shape == (2,) for c in calls)


def test_prefill_clobbers_live_slots_on_both_engines():
    """A second request's prefill runs the whole (B, 1) batch, zero tokens
    in slot 0, so it overwrites slot 0's K/V rows at the prompt
    positions; then both slots decode at one position, the larger one.
    The port keeps both behaviours of the reference (ROADMAP queue 3)."""
    cfg_r, cfg_t = _cfgs()
    rp, tp = _params(cfg_r, cfg_t, seed=2)
    ref_eng = rengine.DecodeEngine(rp, cfg_r, single_device_ctx(), batch_slots=2, max_seq=16)
    eng = DecodeEngine(tp, cfg_t, batch_slots=2, max_seq=16)
    prompts = (np.array([5, 6], np.int32), np.array([7, 8, 9], np.int32))
    snaps = []
    for e, mod in ((ref_eng, rengine), (eng, None)):
        req = (mod.Request if mod else Request)
        e.submit(req(rid=0, prompt=prompts[0], max_new_tokens=8))
        e.tick()
        k = e.cache["k"]
        before = np.array(k if mod else k.numpy(), np.float32)[:, 0, :3].copy()
        e.submit(req(rid=1, prompt=prompts[1], max_new_tokens=8))
        e.tick()
        k = e.cache["k"]
        after = np.array(k if mod else k.numpy(), np.float32)
        snaps.append((before, after))
        # slot 0's prompt rows (positions 0, 1) were overwritten by slot 1's prefill
        assert np.abs(after[:, 0, :2] - before[:, :2]).max() > 1e-3
        assert list(e.slot_pos) == [4, 4]
    (rb, ra), (tb, ta) = snaps
    np.testing.assert_allclose(tb, rb, rtol=F32_CACHE_TOL, atol=F32_CACHE_TOL)
    np.testing.assert_allclose(ta, ra, rtol=F32_CACHE_TOL, atol=F32_CACHE_TOL)


def test_unported_options_raise_and_entry_points_default_to_the_card():
    """``tier=`` and MoE configs, which raised before the serving slice, now
    serve: a tier's policy runs before each tick's admissions and its
    counters ride along in ``metrics()``; an MoE ``init`` draws the nested
    ``moe`` dict.  The entry points still default to the card."""
    cfg_r, cfg_t = _cfgs()
    _, tp = _params(cfg_r, cfg_t)
    calls = []

    class Tier:
        def maybe_compact(self):
            calls.append("compact")

        def maybe_rebalance(self):
            calls.append("rebalance")

        def metrics(self):
            return {"lookups": len(calls)}

    eng = DecodeEngine(tp, cfg_t, batch_slots=2, max_seq=8, tier=Tier())
    eng.submit(Request(rid=0, prompt=np.array([1], np.int32), max_new_tokens=2))
    assert eng.tick() and calls == ["compact", "rebalance"]
    assert eng.metrics()["tier"] == {"lookups": 2}
    moe = tconfigs.get("qwen3-moe-235b-a22b", reduced=True).config
    p = tt.init(torch.Generator(), moe)
    assert p["layers"]["moe"]["wg"].shape == (moe.n_layers, moe.n_experts, moe.d_model,
                                              moe.d_ff_expert)
    assert "wg" not in p["layers"]  # no shared expert
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.init_cache(cfg_t, 2, 8)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.params_from_numpy({"embed": np.zeros((2, 2), np.float32)}, cfg_t)
    kernels.reset_launches()
    eng = DecodeEngine(tp, cfg_t, batch_slots=2, max_seq=8)
    assert eng.device.type == "cpu" and eng.params["embed"].dtype == torch.float32
    eng.submit(Request(rid=0, prompt=np.array([1, 2], np.int32), max_new_tokens=2))
    assert eng.run_until_drained() == 1
    assert kernels.launches()["decode_attention"] == 0  # the CPU runs the twin
