"""The port's LM prefill path (``layers.causal_attention``,
``transformer.forward`` and the ``prefill`` cell of ``launch.steps``)
held against the JAX reference on the CPU.

The same weights (the reference's ``transformer.init``, carried across
with ``params_from_numpy``) and the same numpy tokens go through both;
the reference calls are jitted.  Tolerances:
- f32: 2e-5 absolute and relative on hidden states and logits of
  magnitude ~4 (sums in another order: measured differences ~6e-6);
- bf16: 0.1 absolute and 0.05 relative, a few bf16 ulps at |x| ~ 4 (both
  frameworks round every product to bf16, at different places: measured
  0.047 on the reduced qwen2-0.5b's hidden states).  ``causal_attention``
  alone rounds at the same places in both: it is held at the bf16
  tolerance all the same.
The MoE archs are held in f32 only: in bf16 a one-ulp difference in a
router's input flips which expert a token goes to (measured: a hidden
state off by 1.3 on the reduced moonshot), so the two packages compute
different functions there, not the same one less exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist.sharding import single_device_ctx
from repro.launch import steps as rsteps
from repro.models import layers as rlayers
from repro.models import transformer as rt
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as tt

F32_TOL = 2e-5
BF16_ATOL, BF16_RTOL = 0.1, 0.05
LM_ARCHS = ("granite-3-8b", "minitron-8b", "qwen2-0.5b", "moonshot-v1-16b-a3b",
            "qwen3-moe-235b-a22b")
DENSE_ARCHS = LM_ARCHS[:3]
CTX = single_device_ctx()


def _tol(dtype):
    return (F32_TOL, F32_TOL) if dtype == "float32" else (BF16_ATOL, BF16_RTOL)


def _cfgs(arch, dtype):
    r = dataclasses.replace(rconfigs.get(arch, reduced=True).config, dtype=dtype)
    t = dataclasses.replace(tconfigs.get(arch, reduced=True).config, dtype=dtype)
    return r, t


def _params(cfg_r, cfg_t, seed=0):
    rp = rt.init(jax.random.key(seed), cfg_r)
    if cfg_r.qkv_bias:  # non-zero biases, so the test sees them applied
        rng = np.random.default_rng(seed)
        rp["layers"] = {**rp["layers"], **{
            k: jnp.asarray(rng.normal(0, 0.1, rp["layers"][k].shape).astype(np.float32))
            for k in ("bq", "bk", "bv")}}
    return rp, tt.params_from_numpy(jax.tree.map(np.asarray, rp), cfg_t, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("s,q_chunk", [(48, 16), (40, 16)], ids=["divides", "not_divides"])
def test_causal_attention_matches_reference(dtype, group, s, q_chunk):
    """Chunks of 16 rows over 48 positions, and 40 positions, which 16
    does not divide (the whole sequence is one chunk); GQA groups 1 and 4."""
    rng = np.random.default_rng(group * 100 + s)
    hkv, hd = 2, 16
    q = rng.normal(size=(2, s, hkv * group, hd)).astype(np.float32)
    k = rng.normal(size=(2, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(2, s, hkv, hd)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fn = jax.jit(lambda a, b, c: rlayers.causal_attention(a, b, c, q_chunk=q_chunk))
    want = np.asarray(fn(*(jnp.asarray(x).astype(jdt) for x in (q, k, v))).astype(jnp.float32))
    got = tlayers.causal_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                   q_chunk=q_chunk)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    atol, rtol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=rtol)


def test_causal_attention_is_causal():
    """Changing the last position's keys and values changes no earlier row."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 24, 4, 8)).astype(np.float32))
               for _ in range(3))
    a = tlayers.causal_attention(q, k, v, q_chunk=8)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1] += 5.0
    v2[:, -1] -= 5.0
    b = tlayers.causal_attention(q, k2, v2, q_chunk=8)
    assert torch.equal(a[:, :-1], b[:, :-1]) and not torch.equal(a[:, -1], b[:, -1])


FORWARD_CASES = [(a, "float32") for a in LM_ARCHS] + [(a, "bfloat16") for a in DENSE_ARCHS]


@pytest.mark.parametrize("arch,dtype", FORWARD_CASES)
def test_forward_matches_reference(arch, dtype):
    """Final hidden states of 2 sequences of 128 tokens (two 64-row chunks
    of the reduced configs' ``q_chunk``)."""
    cfg_r, cfg_t = _cfgs(arch, dtype)
    assert cfg_t.q_chunk == cfg_r.q_chunk == 64
    rp, tp = _params(cfg_r, cfg_t)
    toks = np.random.default_rng(11).integers(0, cfg_r.vocab, (2, 128)).astype(np.int32)
    want = jax.jit(lambda p, t: rt.forward(p, t, cfg_r, CTX))(rp, jnp.asarray(toks))
    got = tt.forward(tp, torch.from_numpy(toks), cfg_t)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, 128, cfg_t.d_model)
    atol, rtol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def _f32_spec(pkg, arch):
    spec = pkg.get(arch, reduced=True)
    return dataclasses.replace(spec, config=dataclasses.replace(spec.config, dtype="float32"))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_cell_matches_reference(arch):
    """The ``prefill_32k`` cell of each reduced arch (2 x 128 tokens) in
    f32: the same inputs from one seed, then each package's step function;
    the last position's logits (f32) agree."""
    rspec, tspec = _f32_spec(rconfigs, arch), _f32_spec(tconfigs, arch)
    rcell, tcell = (next(c for c in s.shapes if c.kind == "prefill") for s in (rspec, tspec))
    rbatch = rsteps.make_inputs(rspec, rcell, False, np.random.default_rng(3))
    tbatch = tsteps.make_inputs(tspec, tcell, np.random.default_rng(3), device="cpu")
    np.testing.assert_array_equal(tbatch["tokens"].numpy(), np.asarray(rbatch["tokens"]))
    rp, tp = _params(rspec.config, tspec.config)
    want = jax.jit(rsteps.build_step(rspec, rcell, CTX).fn)(rp, rbatch)
    bundle = tsteps.build_step(tspec, tcell)
    got = bundle.fn(tp, tbatch)
    assert bundle.kind == "prefill" and bundle.cfg == tspec.config
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, tspec.config.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "moonshot-v1-16b-a3b"))
def test_prefill_last_logits_equal_decode_chain(arch):
    """Within the port, in f32: the prefill's last logits equal the last
    step of a ``decode_step`` chain over the same 24 tokens (kernel
    attention: its twin on the CPU).  Capacity differs between a
    24-token forward and 1-token steps, so the MoE case takes a capacity
    factor at which nothing drops."""
    cfg = dataclasses.replace(tconfigs.get(arch, reduced=True).config, dtype="float32",
                              q_chunk=8, capacity_factor=100.0)
    params = tt.init(torch.Generator().manual_seed(5), cfg)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, (3, 24)))
    h = tt.forward(params, toks, cfg)
    want = (h[:, -1] @ params["head"]).float()
    cache = tt.init_cache(cfg, 3, 32, device="cpu")
    for pos in range(24):
        got, cache = tt.decode_step(params, cache, toks[:, pos:pos + 1], pos, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("cell_name", ["prefill_32k", "decode_32k", "long_500k"])
def test_lm_make_inputs_match_reference(arch, cell_name):
    rspec, tspec = rconfigs.get(arch, reduced=True), tconfigs.get(arch, reduced=True)
    rcell = next(c for c in rspec.shapes if c.name == cell_name)
    tcell = next(c for c in tspec.shapes if c.name == cell_name)
    want = rsteps.make_inputs(rspec, rcell, False, np.random.default_rng(9))
    got = tsteps.make_inputs(tspec, tcell, np.random.default_rng(9), device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


def test_training_cells_raise_until_their_slice():
    """The ``train`` cells build since the training slice (a step, its
    ``init_fn``, the cell's batch), and DimeNet's ``graph_train`` cells
    since the DimeNet slice; a ``graph_train`` cell on a spec of another
    family raises ``ValueError((family, kind))``."""
    from repro_torch.configs import ShapeCell

    for arch, cell_name, label in (("qwen2-0.5b", "train_4k", "labels"),
                                   ("din", "train_batch", "label"),
                                   ("dimenet", "full_graph_sm", "labels")):
        spec = tconfigs.get(arch, reduced=True)
        cell = next(c for c in spec.shapes if c.name == cell_name)
        bundle = tsteps.build_step(spec, cell)
        assert bundle.kind == cell.kind and callable(bundle.fn) and callable(bundle.init_fn)
        assert label in tsteps.make_inputs(spec, cell, device="cpu")
        if spec.family == "gnn":
            continue
        graph = ShapeCell("full_graph_sm", "graph_train", {"n_nodes": 8, "n_edges": 16})
        with pytest.raises(ValueError) as err:
            tsteps.build_step(spec, graph)
        assert err.value.args[0] == (spec.family, "graph_train")
        with pytest.raises(ValueError):
            tsteps.make_inputs(spec, graph, device="cpu")


def test_decode_cell_is_decode_step():
    """The ``decode_32k`` cell's step is ``transformer.decode_step``: the
    same logits and cache as calling it directly."""
    spec = _f32_spec(tconfigs, "qwen2-0.5b")
    cell = next(c for c in spec.shapes if c.name == "decode_32k")
    cfg = spec.config
    params = tt.init(torch.Generator().manual_seed(2), cfg)
    batch = tsteps.make_inputs(spec, cell, np.random.default_rng(2), device="cpu")
    caches = [tt.init_cache(cfg, cell.dims["global_batch"], 16, device="cpu") for _ in range(2)]
    got, c0 = tsteps.build_step(spec, cell).fn(params, caches[0], batch, 3)
    want, c1 = tt.decode_step(params, caches[1], batch["tokens"], 3, cfg)
    assert torch.equal(got, want) and all(torch.equal(c0[k], c1[k]) for k in ("k", "v"))
