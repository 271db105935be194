"""The exact form of the corridor scan, in parallel over chunks, held bit for
bit against the serial walk and the JAX reference.

``corridor_scan_exact`` speculates each chunk from a fresh carry, corrects
it from its predecessor's end carry until both walks flag one element, and
walks the chunks after an unsynced one again from the true carry
(``kernels/corridor_scan.py``).  On the CPU it runs its twin,
:func:`~repro_torch.kernels.corridor_scan.corridor_scan_exact_twin`, the
same three phases.  Its flags must equal ``corridor_scan_twin``'s serial
walk (``chunk >= length``) and the reference's ``pgm_segments_scan`` /
``rs_knots_scan`` (jitted, each table's reference masks computed once in
the module fixture ``ref``) on the table shapes of
``test_torch_device_fit`` (f64-colliding keys included: NaN cones), with a
live count, on tables of 1-3 keys and a table whose tail is one segment,
for chunks of 1 and 7 elements, one shorter than the longest segment and
one longer than the row, and resolve windows from 3 to 4,096 elements.
Flags are bools: equal, no tolerance.  Two facts the correction rests on
are pinned on their own: after a flag the carry depends on the element
alone, and a fresh start leaves that carry (PGM by flagging, RS without).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import cdf as tcdf
from repro_torch.core import pgm as tpgm
from repro_torch.core import radix_spline as trs
from repro_torch.kernels import corridor_scan as cs

from test_torch_device_fit import EPS, N, TABLES, _f64, _np, _r_pgm_scan, _r_rs_scan, _table

#: chunk cases: (name, resolve window); the chunk of "segment" is half the
#: longest serial segment, of "row" one past the row
CHUNKS = (("1", 4096), ("7", 64), ("segment", 5), ("row", 4096))


def _tiny(n: int) -> np.ndarray:
    return _f64(np.arange(n, dtype=np.uint64) * 5 + 1)


def _tail() -> np.ndarray:
    """200 clustered keys, then the rest of the row on one line."""
    head = np.sort(np.random.default_rng(3).choice(10**6, 200, replace=False)).astype(np.uint64)
    return _f64(np.concatenate([head, head[-1] + 1000 + np.arange(N - 200, dtype=np.uint64) * 7]))


@pytest.fixture(scope="module")
def ref():
    """The module's reference masks (jitted, once a module): (table, ε) ->
    its PGM mask, its mask over a live third and its RS knot mask; ("tiny",
    n) -> the PGM and RS masks of n keys at ε 4; ("tail", rec) -> the tail
    table's mask at ε 8."""
    import jax.numpy as jnp

    out = {}
    for name in TABLES:
        k = _f64(_table(name))
        for eps in EPS:
            out[(name, eps)] = (_np(_r_pgm_scan(k, eps)),
                                _np(_r_pgm_scan(k, eps, count=jnp.asarray(N // 3))),
                                _np(_r_rs_scan(k, eps)))
    for n in (1, 2, 3):
        out[("tiny", n)] = (_np(_r_pgm_scan(_tiny(n), 4.0)), _np(_r_rs_scan(_tiny(n), 4.0)))
    out[("tail", "pgm")] = _np(_r_pgm_scan(_tail(), 8.0))
    out[("tail", "rs")] = _np(_r_rs_scan(_tail(), 8.0))
    return out


def _serial(keys, eps, recurrence, length, count=None):
    return cs.corridor_scan_twin(keys, eps, recurrence=recurrence, length=length, chunk=length,
                                 count=count)


def _chunk_of(case: str, serial, length: int) -> int:
    if case == "segment":
        bounds = np.concatenate([[0], np.flatnonzero(serial.numpy()[0]), [length]])
        return max(2, int(np.diff(bounds).max()) // 2)
    return {"1": 1, "7": 7, "row": length + 1}[case]


def _rs_mask(flags, n):
    """``rs_knots_scan``'s mask from the interior flags."""
    mask = torch.nn.functional.pad(flags, (0, 2))
    mask[:, 0] = True
    mask[:, n - 1] = True
    return mask


@pytest.mark.parametrize("case,window", CHUNKS)
@pytest.mark.parametrize("name", TABLES)
def test_exact_twin_matches_serial_and_reference(ref, name, case, window):
    k = torch.from_numpy(_f64(_table(name)))[None]
    for eps in EPS:
        e = torch.tensor([eps], dtype=torch.float64)
        want_pgm, want_cnt, want_rs = ref[(name, eps)]
        cnt = torch.tensor([N // 3])
        for rec, length, count, want in (("pgm", N, None, want_pgm), ("pgm", N, cnt, want_cnt),
                                         ("rs", N - 2, None, want_rs)):
            serial = _serial(k, e, rec, length, count)
            chunk = _chunk_of(case, serial, length)
            got = cs.corridor_scan_exact_twin(k, e, recurrence=rec, length=length, count=count,
                                              chunk=chunk, window=window)
            what = (rec, eps, count is not None, chunk)
            assert torch.equal(got, serial), what
            got = got if rec == "pgm" else _rs_mask(got, N)
            np.testing.assert_array_equal(got[0].numpy(), want, err_msg=str(what))


@pytest.mark.parametrize("n", (1, 2, 3))
def test_exact_on_tiny_tables(ref, n):
    """Tables of 1-3 keys: PGM over every key, RS over its n - 2 interior
    points (none below 3 keys), at chunks of 1 and 7."""
    k = torch.from_numpy(_tiny(n))[None]
    e = torch.tensor([4.0], dtype=torch.float64)
    for rec, length in (("pgm", n), ("rs", n - 2))[:1 + (n > 1)]:
        serial = cs.corridor_scan_twin(k, e, recurrence=rec, length=length, chunk=max(length, 1))
        for chunk in (1, 7):
            got = cs.corridor_scan_exact(k, e, recurrence=rec, length=length, chunk=chunk)
            assert got.shape == (1, length) and torch.equal(got, serial), (rec, chunk)
    np.testing.assert_array_equal(_np(tpgm.pgm_segments_scan(k[0], 4.0)), ref[("tiny", n)][0])
    np.testing.assert_array_equal(_np(trs.rs_knots_scan(k[0], 4.0)), ref[("tiny", n)][1])


@pytest.mark.parametrize("recurrence", ("pgm", "rs"))
def test_a_tail_of_one_segment_crosses_many_chunks(ref, recurrence):
    """After 200 clustered keys the rest of the row lies on one line, so no
    chunk of the tail can sync (its speculative walk flags its first
    element, the true walk flags none there): the resolve walks the whole
    tail from the true carry, across 50 chunks of 16, through windows of
    64 elements."""
    k = torch.from_numpy(_tail())[None]
    e = torch.tensor([8.0], dtype=torch.float64)
    length = N if recurrence == "pgm" else N - 2
    serial = _serial(k, e, recurrence, length)
    assert int(serial[0, 256:].sum()) <= 1  # the tail is one segment
    got = cs.corridor_scan_exact_twin(k, e, recurrence=recurrence, length=length, chunk=16,
                                      window=64)
    assert torch.equal(got, serial)
    got = got if recurrence == "pgm" else _rs_mask(got, N)
    np.testing.assert_array_equal(got[0].numpy(), ref[("tail", recurrence)])


def _bits(carry):
    return [float(a).hex() for a in carry]


@pytest.mark.parametrize("name", TABLES[:3])
def test_the_carry_after_a_flag_and_after_a_fresh_start(name):
    """The sync test's two facts, at every element j0 of a table: PGM's
    fresh carry flags j0 and leaves (x_j0, j0, 0, inf), the carry of any
    flag at j0; RS's fresh carry (keys[j0], j0, -inf, inf) does not flag
    j0 and leaves, bit for bit, the carry a flag at j0 leaves from another
    anchor."""
    keys = torch.from_numpy(_f64(_table(name)))
    e = torch.tensor(16.0, dtype=torch.float64)
    one = torch.ones((), dtype=torch.bool)
    inf = torch.tensor(float("inf"), dtype=torch.float64)
    for j0 in range(1, N - 2, 97):
        x, r = keys[j0], torch.tensor(float(j0), dtype=torch.float64)
        fresh = (x * 0, r * 0 - 1.0, x * 0, inf)
        carry, flag = cs._pgm_step(fresh, x, r, one, e)
        assert bool(flag) and _bits(carry) == _bits((x, r, 0.0, inf))
        # a cone that must break at j0: anchored at 0 with an empty slope range
        carry, flag = cs._pgm_step((keys[0], r * 0, inf, inf), x, r, one, e)
        assert bool(flag) and _bits(carry) == _bits((x, r, 0.0, inf))

        xi, rr = keys[j0 + 1], torch.tensor(float(j0 + 1), dtype=torch.float64)
        start, flag = cs._rs_step((x, r, -inf, inf), xi, x, rr, one, e)
        assert not bool(flag)
        knot, flag = cs._rs_step((keys[0], r * 0, inf, inf), xi, x, rr, one, e)
        assert bool(flag) and _bits(start) == _bits(knot)


def test_exact_is_the_cpu_path_of_the_exact_fit():
    """``chunked_corridor_scan`` runs the exact form: on the CPU its twin,
    no launch counted; its operands are checked as ``corridor_scan``'s."""
    stack = torch.from_numpy(np.stack([_f64(_table(n)) for n in TABLES[:3]]))
    eps = torch.tensor([4.0, 16.0, 64.0], dtype=torch.float64)
    kernels.reset_launches()
    got = tcdf.chunked_corridor_scan("pgm", stack, eps, N)
    assert kernels.launches()["corridor_scan"] == kernels.launches()["corridor_scan_exact"] == 0
    assert torch.equal(got, _serial(stack, eps, "pgm", N))
    with pytest.raises(ValueError, match="chunk"):
        cs.corridor_scan_exact(stack, eps, recurrence="pgm", length=N, chunk=0)
    with pytest.raises(ValueError, match="length"):
        cs.corridor_scan_exact(stack, eps, recurrence="rs", length=N, chunk=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cs.corridor_scan_exact(stack.to("meta"), eps.to("meta"), recurrence="pgm", length=N)
