"""The port's decode-attention and embedding-bag twins held against the
JAX Pallas kernels.

``_decode_body`` and ``_bag_body`` are the plain PyTorch versions of the
hand-written CUDA kernels; their wrappers run them on CPU tensors.  Fed
the same numpy inputs, each must match the reference's Pallas kernel (in
interpret mode, through ``repro.kernels.ops``) within the reference's own
test tolerances (``tests/test_kernels.py``: 3e-4 attention, 3e-5 bag,
f32 sums in another order), and the reference oracle ``ref.*_ref``
wherever that oracle defines the value.  The two places it does not:
a row with ``kv_len = 0`` (the oracle gives NaN, the kernel 0) and an id
outside ``[0, V)`` (the oracle gathers NaN, the kernel adds nothing).
The CUDA kernels are held against the twins on the card in
``test_torch_gpu.py``.
"""

import jax  # noqa: F401  — both frameworks in one process; data passes as numpy
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (
    MAX_SPLIT,
    _decode_body,
    _decode_split_body,
    decode_attention,
    split_plan,
)
from repro_torch.kernels.embedding_bag import _bag_body, embedding_bag

ATT_TOL = 3e-4
BAG_TOL = 3e-5

#: (b, hq, hkv, d, s, s_tile): the reference test's shapes, GQA group 7
#: (qwen2-0.5b's 14/2 heads) and group 4 at head dim 128
ATT_SHAPES = [
    (2, 4, 4, 16, 64, 32),
    (3, 8, 2, 32, 300, 128),
    (1, 16, 1, 64, 512, 256),
    (3, 14, 2, 64, 200, 64),
    (2, 32, 8, 128, 96, 32),
]


def _attention_inputs(seed, b, hq, hkv, d, s):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    kvl = rng.integers(1, s + 1, size=b).astype(np.int32)
    return q, k, v, kvl


def _pallas_attention(q, k, v, kvl, s_tile):
    return np.asarray(rops.decode_attention(q, k, v, kvl, s_tile=s_tile))


def _twin_attention(q, k, v, kvl):
    t = [torch.from_numpy(x) for x in (q, k, v, kvl)]
    return _decode_body(*t).numpy()


@pytest.mark.parametrize("b,hq,hkv,d,s,stile", ATT_SHAPES)
def test_decode_body_matches_pallas_and_ref(b, hq, hkv, d, s, stile):
    q, k, v, kvl = _attention_inputs(7, b, hq, hkv, d, s)
    got = _twin_attention(q, k, v, kvl)
    np.testing.assert_allclose(got, _pallas_attention(q, k, v, kvl, stile), rtol=ATT_TOL, atol=ATT_TOL)
    want = np.asarray(rref.decode_attention_ref(*(jnp.asarray(x) for x in (q, k, v, kvl))))
    np.testing.assert_allclose(got, want, rtol=ATT_TOL, atol=ATT_TOL)
    port_ref = ref.decode_attention_ref(*(torch.from_numpy(x) for x in (q, k, v, kvl))).numpy()
    np.testing.assert_allclose(port_ref, want, rtol=ATT_TOL, atol=ATT_TOL)


@pytest.mark.parametrize("kv_lens", [(0, 1, 300), (0, 0, 0), (1, 128, 129)])
def test_decode_body_edge_lengths(kv_lens):
    """kv_len 0 gives 0 (``acc / max(l, 1e-30)``), as the Pallas kernel does;
    1, a tile edge and S give the oracle's value."""
    q, k, v, _ = _attention_inputs(8, 3, 14, 2, 64, 300)
    kvl = np.asarray(kv_lens, np.int32)
    got = _twin_attention(q, k, v, kvl)
    np.testing.assert_allclose(got, _pallas_attention(q, k, v, kvl, 128), rtol=ATT_TOL, atol=ATT_TOL)
    zero = kvl == 0
    assert (got[zero] == 0).all()
    if (~zero).any():
        want = np.asarray(rref.decode_attention_ref(*(jnp.asarray(x) for x in (q, k, v, kvl))))
        np.testing.assert_allclose(got[~zero], want[~zero], rtol=ATT_TOL, atol=ATT_TOL)
        assert np.isnan(np.asarray(want[zero])).all()


def test_ops_decode_attention_pads_like_the_reference():
    """``ops.decode_attention`` pads the cache with zero rows to a multiple
    of ``s_tile``, as the reference does: a ``kv_len`` past S then attends
    to those zero rows, and a ``kv_len`` within S does not depend on it."""
    q, k, v, _ = _attention_inputs(9, 3, 8, 2, 32, 300)
    for kvl, s_tile in (((350, 20, 300), 128), ((17, 300, 299), 7)):
        kvl = np.asarray(kvl, np.int32)
        got = ops.decode_attention(q, k, v, kvl, s_tile=s_tile, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), _pallas_attention(q, k, v, kvl, s_tile),
                                   rtol=ATT_TOL, atol=ATT_TOL)


def test_decode_attention_wrapper_on_cpu_takes_the_twin_in_either_dtype():
    q, k, v, kvl = _attention_inputs(10, 2, 14, 2, 64, 40)
    kernels.reset_launches()
    for dt in (torch.float32, torch.bfloat16):
        t = [torch.from_numpy(x).to(dt) for x in (q, k, v)]
        got = decode_attention(*t, torch.from_numpy(kvl))
        assert got.dtype == dt and got.shape == (2, 14, 64)
        want = _decode_body(*(x.float() for x in t), torch.from_numpy(kvl))
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=1e-2, atol=1e-2)
    assert kernels.launches()["decode_attention"] == 0
    with pytest.raises(ValueError):
        decode_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(kvl[:1]))
    with pytest.raises(TypeError):
        decode_attention(*(torch.from_numpy(x).double() for x in (q, k, v)), torch.from_numpy(kvl))


#: (hq, hkv, d): groups 1, 4, 7 (qwen2-0.5b) and 16 at head dims 64 and 128
SPLIT_SHAPES = [
    (4, 4, 64), (4, 4, 128), (32, 8, 64), (32, 8, 128),
    (14, 2, 64), (14, 2, 128), (16, 1, 64), (16, 1, 128),
]
SPLIT_TOL = 2e-5  # f32 sums in another order


@pytest.mark.parametrize("hq,hkv,d", SPLIT_SHAPES)
def test_decode_split_body_matches_pallas_and_one_pass(hq, hkv, d):
    """The CUDA kernel's split-and-combine arithmetic: each row's tiles cut
    into ``n_split`` tile-aligned shares of its own ``kv_len``, combined
    as ``sum e^(m - M) acc / max(sum e^(m - M) l, 1e-30)``.  Lengths 0, 1,
    a tile - 1, + 0 and + 1, S, and rows shorter than ``n_split`` tiles
    (so some shares are empty), for splits of 1 to more than S has
    tiles: within 2e-5 of the Pallas kernel and of the one-pass twin."""
    tile, s = 16, 160
    q, k, v, _ = _attention_inputs(16, 8, hq, hkv, d, s)
    kvl = np.asarray([0, 1, tile - 1, tile, tile + 1, s, 2 * tile + 3, 5 * tile - 2], np.int32)
    pallas = _pallas_attention(q, k, v, kvl, 32)
    one_pass = _twin_attention(q, k, v, kvl)
    t = [torch.from_numpy(x) for x in (q, k, v, kvl)]
    for n_split in (1, 2, 3, 7, 12):
        got = _decode_split_body(*t, n_split, tile).numpy()
        np.testing.assert_allclose(got, pallas, rtol=SPLIT_TOL, atol=SPLIT_TOL, err_msg=str(n_split))
        np.testing.assert_allclose(got, one_pass, rtol=SPLIT_TOL, atol=SPLIT_TOL,
                                   err_msg=str(n_split))
        assert (got[0] == 0).all()


def _direct_lse(q, k, v, kvl):
    """Each row's log-sum-exp of its scaled logits over its first
    ``kv_len`` positions, in f64 (``-1e30`` for an empty row)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    q4 = q.astype(np.float64).reshape(b, hkv, hq // hkv, d)
    logits = np.einsum("bkgd,bskd->bkgs", q4, k.astype(np.float64)) / np.sqrt(d)
    out = np.full((b, hq), -1e30)
    for i, n in enumerate(kvl):
        n = min(int(n), k.shape[1])
        if n:
            lg = logits[i, :, :, :n]
            m = lg.max(axis=-1, keepdims=True)
            out[i] = (m[..., 0] + np.log(np.exp(lg - m).sum(axis=-1))).reshape(hq)
    return out


@pytest.mark.parametrize("hq,hkv,d", [(14, 2, 64), (16, 1, 64), (4, 4, 128)])
def test_twins_return_the_log_sum_exp(hq, hkv, d):
    """``return_lse``: ``_decode_body`` and ``_decode_split_body`` give the
    output in f32 (the default path's before its cast) and each row's
    log-sum-exp, within 2e-5 of a direct f64 one; ``-1e30`` and 0 for a
    row with ``kv_len = 0``; the wrapper on CPU tensors returns the pair."""
    tile, s = 16, 160
    q, k, v, _ = _attention_inputs(17, 6, hq, hkv, d, s)
    kvl = np.asarray([0, 1, tile + 1, s, s + 9, 3 * tile - 2], np.int32)
    t = [torch.from_numpy(x) for x in (q, k, v, kvl)]
    want = _direct_lse(q, k, v, kvl)
    out, lse = _decode_body(*t, return_lse=True)
    assert out.dtype == lse.dtype == torch.float32 and lse.shape == (6, hq)
    np.testing.assert_allclose(lse.numpy(), want, rtol=SPLIT_TOL, atol=SPLIT_TOL)
    assert torch.equal(out, _decode_body(*t))
    assert (out[0] == 0).all() and (lse[0] == -1e30).all()
    for n_split in (1, 3, 12):
        o, l_ = _decode_split_body(*t, n_split, tile, return_lse=True)
        np.testing.assert_allclose(l_.numpy(), want, rtol=SPLIT_TOL, atol=SPLIT_TOL)
        np.testing.assert_allclose(o.numpy(), out.numpy(), rtol=SPLIT_TOL, atol=SPLIT_TOL)
    bf = [x.to(torch.bfloat16) for x in t[:3]]
    o, l_ = decode_attention(*bf, t[3], return_lse=True)
    assert o.dtype == torch.float32 and torch.equal(o.to(torch.bfloat16), decode_attention(*bf, t[3]))


@pytest.mark.parametrize("n_blocks", [2, 4])
def test_twin_blocks_combine_to_the_whole_call(n_blocks):
    """The twin with ``return_lse`` on each of ``n_blocks`` sequence
    blocks (local lengths ``clamp(kv_len - offset, 0, S / n)``), combined
    with weights ``exp(lse - max lse)``, == the one call on the whole
    cache within 2e-5: rows ending in the first block (the later blocks
    empty), on a block edge, in the last, at 0 (every block empty: 0)."""
    from repro_torch.models.layers import combine_softmax_shards

    s = 128
    q, k, v, _ = _attention_inputs(18, 6, 14, 2, 64, s)
    kvl = np.asarray([0, 1, s // 4, s // 2 + 1, s - 3, s], np.int32)
    t = [torch.from_numpy(x) for x in (q, k, v, kvl)]
    s_loc = s // n_blocks
    outs, lses = [], []
    for i in range(n_blocks):
        blk = slice(i * s_loc, (i + 1) * s_loc)
        o, l_ = _decode_body(t[0], t[1][:, blk], t[2][:, blk],
                             torch.clamp(t[3] - i * s_loc, 0, s_loc), return_lse=True)
        outs.append(o)
        lses.append(l_)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))[..., None]
    got = (w * torch.stack(outs)).sum(dim=0) / w.sum(dim=0)
    np.testing.assert_allclose(got.numpy(), _decode_body(*t).numpy(), rtol=SPLIT_TOL,
                               atol=SPLIT_TOL)
    assert (got[0] == 0).all()
    # one rank alone (no mesh axes): the helper returns its own block's output
    same = combine_softmax_shards(outs[0], lses[0], (), None, torch.float32)
    np.testing.assert_allclose(same.numpy(), outs[0].numpy(), rtol=1e-6, atol=1e-6)


def test_split_plan_fills_the_card_and_bounds_the_stage():
    """bf16 at head dims 16-128 takes the tensor-core kernel's 16-position
    tiles; otherwise a tile holds 8 KiB of K a stage (at most 64
    positions).  The split aims at 16 blocks an SM, cuts at most 16
    shares, and never more than a full row has tiles."""
    # qwen2-0.5b's decode_32k cell, the roofline shape in f32 and bf16, the serving cache
    assert split_plan(128, 2, 64, 32768, 2, 132) == (16, 9)
    assert split_plan(8, 8, 128, 32768, 4, 132) == (16, 16)
    assert split_plan(8, 8, 128, 32768, 2, 132) == (16, 16)
    assert split_plan(8, 2, 64, 32768, 2, 132) == (16, 16)
    assert split_plan(1, 1, 256, 32768, 4, 132)[0] == 8
    assert split_plan(1, 1, 256, 32768, 2, 132)[0] == 16
    assert split_plan(1, 1, 8, 32768, 2, 132)[0] == 64
    assert split_plan(1, 1, 64, 32768, 4, 132)[0] == 32
    assert split_plan(2, 1, 64, 100, 2, 132) == (16, 7)
    assert split_plan(64, 2, 64, 32768, 2, 132) == (16, 16)
    assert split_plan(1024, 8, 64, 32768, 2, 132) == (16, 1)
    for b in (1, 3, 16, 128, 4096):
        for hkv in (1, 2, 8):
            for d, itemsize in ((8, 4), (64, 2), (128, 4), (256, 2)):
                for s in (1, 15, 700, 32768):
                    tile, n_split = split_plan(b, hkv, d, s, itemsize, 132)
                    assert 1 <= n_split <= min(MAX_SPLIT, -(-s // tile))


#: (v, d, n_items, bags, v_tile): the reference test's shapes, and widths
#: that are not a multiple of 4 (the CUDA kernel's scalar path)
BAG_SHAPES = [
    (100, 8, 50, 4, 32),
    (1000, 64, 300, 16, 512),
    (513, 32, 128, 8, 128),
    (100, 1, 50, 4, 32),
    (300, 3, 200, 8, 128),
    (257, 130, 400, 16, 128),
]


def _bag_inputs(seed, v, d, n_items, bags, sort=True):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, n_items).astype(np.int32)
    seg = rng.integers(0, bags, n_items).astype(np.int32)
    if sort:
        seg = np.sort(seg)
    w = rng.normal(size=n_items).astype(np.float32)
    return table, ids, seg, w


def _twin_bag(table, ids, seg, w, bags):
    return _bag_body(*(torch.from_numpy(x) for x in (table, ids, seg, w)), num_bags=bags).numpy()


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("v,d,n_items,bags,vtile", BAG_SHAPES)
def test_bag_body_matches_pallas_and_ref(v, d, n_items, bags, vtile, sort):
    table, ids, seg, w = _bag_inputs(11, v, d, n_items, bags, sort)
    got = _twin_bag(table, ids, seg, w, bags)
    pallas = np.asarray(rops.embedding_bag(table, ids, seg, w, num_bags=bags, v_tile=vtile))
    np.testing.assert_allclose(got, pallas, rtol=BAG_TOL, atol=BAG_TOL)
    want = np.asarray(rref.embedding_bag_ref(*(jnp.asarray(x) for x in (table, ids, seg, w)), bags))
    np.testing.assert_allclose(got, want, rtol=BAG_TOL, atol=BAG_TOL)
    port_ref = ref.embedding_bag_ref(*(torch.from_numpy(x) for x in (table, ids, seg, w)), bags)
    np.testing.assert_allclose(port_ref.numpy(), want, rtol=BAG_TOL, atol=BAG_TOL)


def test_bag_out_of_range_ids_and_bags_add_nothing():
    """Ids outside [0, V) (negative, V, and in the reference's vocabulary
    padding) and bags outside [0, num_bags) contribute nothing, as in the
    Pallas kernel; the oracle's NaN rows are where it gathers out of range."""
    table, ids, seg, w = _bag_inputs(12, 513, 32, 128, 8, sort=False)
    ids[:6] = [-1, -7, 513, 600, 2**31 - 1, -(2**31)]
    seg[6:9] = [-1, 8, 100]
    got = _twin_bag(table, ids, seg, w, 8)
    pallas = np.asarray(rops.embedding_bag(table, ids, seg, w, num_bags=8, v_tile=128))
    np.testing.assert_allclose(got, pallas, rtol=BAG_TOL, atol=BAG_TOL)
    keep = np.ones(len(ids), bool)
    keep[:9] = False
    want = np.zeros_like(got)
    np.add.at(want, seg[keep], table[ids[keep]] * w[keep][:, None])
    np.testing.assert_allclose(got, want, rtol=BAG_TOL, atol=BAG_TOL)
    port_ref = ref.embedding_bag_ref(*(torch.from_numpy(x) for x in (table, ids, seg, w)), 8).numpy()
    assert np.isnan(port_ref[seg[2:4]]).all()


def test_ops_embedding_bag_weights_none_means_ones():
    table, ids, seg, _ = _bag_inputs(13, 1000, 64, 300, 16, sort=False)
    got = ops.embedding_bag(table, ids, seg, num_bags=16, v_tile=512, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (16, 64)
    pallas = np.asarray(rops.embedding_bag(table, ids, seg, None, num_bags=16, v_tile=512))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=BAG_TOL, atol=BAG_TOL)
    # an unported tile size changes no result
    again = ops.embedding_bag(table, ids, seg, num_bags=16, v_tile=7, device="cpu")
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_embedding_bag_wrapper_checks_operands_and_counts_no_cpu_launch():
    table, ids, seg, w = (torch.from_numpy(x) for x in _bag_inputs(14, 100, 8, 50, 4))
    kernels.reset_launches()
    out = embedding_bag(table, ids, seg, w, num_bags=4)
    assert out.shape == (4, 8) and kernels.launches()["embedding_bag"] == 0
    with pytest.raises(TypeError):
        embedding_bag(table, ids.long(), seg, w, num_bags=4)
    with pytest.raises(ValueError):
        embedding_bag(table, ids, seg[:-1], w, num_bags=4)
    with pytest.raises(TypeError):
        embedding_bag(table.double(), ids, seg, w, num_bags=4)


def test_entry_points_default_to_the_card():
    """Numpy inputs with no ``device`` go to the card, which this machine
    may lack: then the call raises instead of running on the CPU."""
    table, ids, seg, w = _bag_inputs(15, 100, 8, 50, 4)
    q, k, v, kvl = _attention_inputs(15, 1, 4, 4, 16, 8)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.embedding_bag(table, ids, seg, w, num_bags=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.decode_attention(q, k, v, kvl)
