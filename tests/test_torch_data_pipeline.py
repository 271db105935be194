"""The port's LM token pipeline (``data.pipeline``), graph sampler
(``data.sampler``) and the ``train`` cells' inputs (``launch.steps``)
held against the JAX reference on the CPU.  They make the same numpy
draws from the same seed, so arrays, index leaves, batches and the
learned lookups' ranks are compared bit for bit: no tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import pipeline as rpipe
from repro.data import sampler as rsamp
from repro.launch import steps as rsteps
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe
from repro_torch.data import sampler as tsamp
from repro_torch.launch import steps as tsteps

LM_ARCHS = ("granite-3-8b", "minitron-8b", "qwen2-0.5b", "moonshot-v1-16b-a3b",
            "qwen3-moe-235b-a22b")
RECSYS_ARCHS = ("dlrm-mlperf", "din", "wide-deep", "sasrec")
CORPUS = dict(vocab_size=1000, n_docs=300, mean_len=64, seed=3)


def _same_model(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, list):
            assert len(g) == len(w), f
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=f)


def _offsets(total, starts, rng):
    return np.unique(np.concatenate([starts, starts[1:] - 1, [0, total - 1],
                                     rng.integers(0, total, 3000)])).astype(np.int64)


def test_synth_corpus_matches_reference():
    want = rpipe.synth_corpus(**CORPUS)
    got = tpipe.synth_corpus(**CORPUS, device="cpu")
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.doc_starts, want.doc_starts)
    assert got.tokens.dtype == np.int32 and got.doc_starts.dtype == np.int64
    _same_model(got.pgm, want.pgm, ("eps", "n", "level_sizes", "level_keys", "level_slope",
                                    "level_rank0"))
    offs = _offsets(len(want.tokens), want.doc_starts, np.random.default_rng(0))
    ranks = np.asarray(want.doc_of(offs))
    np.testing.assert_array_equal(ranks, np.searchsorted(want.doc_starts, offs, "right") - 1)
    got_ranks = got.doc_of(offs)
    assert got_ranks.device.type == "cpu"
    np.testing.assert_array_equal(got_ranks.numpy(), ranks)
    np.testing.assert_array_equal(got.doc_of(torch.from_numpy(offs)).numpy(), ranks)


def test_corpus_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.synth_corpus(**CORPUS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsamp.synth_powerlaw_graph(64, 4, 8)


@pytest.mark.parametrize("num_shards", [1, 2])
def test_token_batcher_matches_reference(num_shards):
    """``batch_at`` for steps 0-2 on every shard: the reference's arrays;
    the shards' rows put together are the one-shard batch."""
    want_c = rpipe.synth_corpus(**CORPUS)
    got_c = tpipe.synth_corpus(**CORPUS, device="cpu")
    whole = tpipe.TokenBatcher(got_c, 8, 32, seed=5)
    for step in range(3):
        rows = []
        for shard in range(num_shards):
            want = rpipe.TokenBatcher(want_c, 8, 32, seed=5, shard=shard,
                                      num_shards=num_shards).batch_at(step)
            got = tpipe.TokenBatcher(got_c, 8, 32, seed=5, shard=shard,
                                     num_shards=num_shards).batch_at(step)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == torch.int32 and tuple(got[k].shape) == (8 // num_shards, 32)
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
            rows.append(got)
        full = whole.batch_at(step)
        for k in full:
            assert torch.equal(torch.cat([r[k] for r in rows]), full[k])
        assert torch.equal(full["tokens"][:, 1:], full["labels"][:, :-1])
    with pytest.raises(ValueError, match="shards"):
        tpipe.TokenBatcher(got_c, 6, 32, num_shards=4)


GRAPH = dict(n_nodes=3000, avg_degree=6, feat_dim=8, seed=2)


def test_powerlaw_graph_and_row_of_edge_match_reference():
    """The CSR arrays, the RMI's leaves (``b = n // 256``) and
    ``row_of_edge`` on every row boundary and on random edges (rows of
    degree 0 repeat an offset: the predecessor is the last of them)."""
    want = rsamp.synth_powerlaw_graph(**GRAPH)
    got = tsamp.synth_powerlaw_graph(**GRAPH, device="cpu")
    np.testing.assert_array_equal(got.row_offsets, want.row_offsets)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    assert (got.n_nodes, got.n_edges, got.feat_dim) == (want.n_nodes, want.n_edges, want.feat_dim)
    assert (np.diff(want.row_offsets) == 0).any()
    _same_model(got.rmi, want.rmi, ("root_type", "root_coef", "b", "leaf_slope", "leaf_icept",
                                    "leaf_eps", "leaf_r", "kmin", "inv_span", "max_eps", "n"))
    rng = np.random.default_rng(1)
    edges = np.concatenate([want.row_offsets[:-1], np.maximum(want.row_offsets[1:] - 1, 0),
                            rng.integers(0, want.n_edges, 5000)])
    ranks = np.asarray(want.row_of_edge(edges))
    got_ranks = got.row_of_edge(edges)
    assert got_ranks.device.type == "cpu"
    np.testing.assert_array_equal(got_ranks.numpy(), ranks)
    for a, b in zip(got.src_dst_arrays(), want.src_dst_arrays()):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fanouts", [(5,), (10, 5, 3)])
def test_sample_neighbors_matches_reference(fanouts):
    want_g = rsamp.synth_powerlaw_graph(**GRAPH)
    got_g = tsamp.synth_powerlaw_graph(**GRAPH, device="cpu")
    seeds = np.random.default_rng(4).integers(0, GRAPH["n_nodes"], 64)
    want = rsamp.sample_neighbors(want_g, seeds, fanouts, seed=9)
    got = tsamp.sample_neighbors(got_g, seeds, fanouts, seed=9)
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == len(fanouts)
    for (gs, gd), (ws, wd) in zip(got[1], want[1]):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gd, wd)


@pytest.mark.parametrize("arch", LM_ARCHS + RECSYS_ARCHS)
def test_train_cell_inputs_match_reference(arch):
    """The ``train`` cell's batch from one seed, and the generator's state
    after it: the recsys label is drawn as a normal and then replaced (the
    reference's ``_recsys_inputs``), and the port makes both draws."""
    rspec, tspec = rconfigs.get(arch, reduced=True), tconfigs.get(arch, reduced=True)
    rcell = next(c for c in rspec.shapes if c.kind == "train")
    tcell = next(c for c in tspec.shapes if c.kind == "train")
    rrng, trng = np.random.default_rng(12), np.random.default_rng(12)
    want = rsteps.make_inputs(rspec, rcell, False, rrng)
    got = tsteps.make_inputs(tspec, tcell, trng, device="cpu")
    assert list(got) == list(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].numpy().dtype == w.dtype and got[k].device.type == "cpu", k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert trng.integers(0, 2**62) == rrng.integers(0, 2**62)
    if tspec.family == "recsys":
        assert set(np.unique(got["label"].numpy())) <= {0.0, 1.0}


def test_full_width_train_cells_keep_the_reference_shapes():
    """The published ``train`` cells (no draws): qwen2-0.5b's ``train_4k``
    is 256 x 4,096 tokens, the recsys ``train_batch`` 65,536 rows."""
    for arch in ("qwen2-0.5b", "din"):
        r, t = rconfigs.get(arch), tconfigs.get(arch)
        rc = next(c for c in r.shapes if c.kind == "train")
        tc = next(c for c in t.shapes if c.kind == "train")
        assert dataclasses.astuple(tc) == dataclasses.astuple(rc)
        shapes = {k: tuple(v.shape) for k, v in rsteps.make_inputs(r, rc, True).items()}
        assert shapes == ({"tokens": (256, 4096), "labels": (256, 4096)} if arch == "qwen2-0.5b"
                          else {"sparse": (65536, 2), "hist": (65536, 100), "label": (65536,)})
