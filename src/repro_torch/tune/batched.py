"""Batched index construction and lookup: one spec over many tables, or
many specs over one table (counterpart of ``repro.tune.batched``).

:func:`build_many` builds one index per table and stacks them leaf-wise
(:mod:`repro_torch.dist.sharded_index`) into a :class:`BatchedIndexes`.
Over same-length tables the result unstacks bit-exactly to per-table
``build``; ragged batches first pad every table to a common power-of-two
length with a strictly increasing continuation, and lookups clamp hits in
the padded tail back to the last real key.  The fit strategies:

* ``fit="host"`` loops the registered host build (bit-exact with
  ``build``);
* ``fit="vmap"`` runs the kind's fit stage once for the whole batch on
  the device: the RMI family's leaf fit (:func:`repro_torch.core.rmi.rmi_leaf_fit`,
  sorted-segment sums, so deterministic; leaf floats may differ from the
  host fit by a few ulp, ranks are exact), and the PGM / PGM_M / RS
  corridor scans (one ``corridor_scan`` launch a batch, per-member ε;
  masks and so leaves bit-exact with the host greedy);
* ``fit="fast"`` (PGM, PGM_M, RS) uses the O(log n)-depth blocked fits
  with a verified-ε re-measure; a member that fails it is re-fit with the
  exact scan, decided on the host after the fast launch;
* ``fit="auto"`` is ``vmap`` for those five kinds and the host build for
  the rest.

:func:`build_grid` builds many specs over one table: RMI-family entries
of one branching factor share one leaf fit, and each of PGM, PGM_M and
RS one corridor-scan launch for its ε grid.

:meth:`BatchedIndexes.lookup` answers a query batch against every table
with ONE launch of the kind's batched kernel (``backend="kernel"``, the
reference's ``"pallas"``): the fused batched RMI, PGM or RadixSpline
kernel where the kind has one, the batched model-free search otherwise.
``"xla"`` and ``"bbs"`` compute every table's windows and search them in
one pass of tensor ops over the stack (the reference vmaps the
single-table path); ``"ref"`` is ``torch.searchsorted`` per row.  The
updatable GAPPED kind stacks too (tables of fewer leaves padded with
inert zero-count leaves) and answers on ``"xla"``, ``"bbs"`` and
``"ref"`` only; ``"kernel"`` raises for it.

Every member the fast fit hands back to the exact scan counts in the
``fit_fast_fallbacks`` metric of :mod:`repro_torch.obs` (labeled
``"PGM"`` or ``"RS"``, as the reference labels them).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.core import keys as keymod
from repro_torch.core.pgm import (
    BICRITERIA_MAX_ITERS,
    bicriteria_eps_bounds,
    build_pgm,
    pgm_fit_fast,
    pgm_segments_scan,
    pla_segments,
    segment_slopes,
)
from repro_torch.core.radix_spline import build_rs, rs_knots_fast, rs_knots_scan
from repro_torch.core.rmi import assemble_rmi, fit_root, rmi_leaf_fit
from repro_torch.dist.sharded_index import (
    _harmonize,
    _pad_sorted_table,
    _pgm_level_arrays,
    _pow2ceil,
    stack_arrays,
)
from repro_torch.index import impls, registry
from repro_torch.index.index import BACKENDS, Index, check_backend, lookup_impl, resolve_device
from repro_torch.index.specs import IndexSpec
from repro_torch.obs import metric
from repro_torch.obs.timing import stopwatch

#: fit strategies (see the module docstring)
FITS = ("host", "vmap", "fast", "auto")

#: kinds with a batched device fit stage: the RMI family's leaf fit and
#: the corridor fits (PGM, the bi-criteria PGM_M, RadixSpline)
VMAP_KINDS = ("RMI", "SY-RMI", "PGM", "PGM_M", "RS")

#: kinds with an O(log n)-depth ``fit="fast"`` corridor fit, whose exact
#: scan is the fallback
FAST_KINDS = ("PGM", "PGM_M", "RS")

#: backends of the batched lookup: all of ``Index.lookup``'s
BATCH_BACKENDS = BACKENDS


def _resolve_spec(kind_or_spec, **params) -> IndexSpec:
    if isinstance(kind_or_spec, IndexSpec):
        return kind_or_spec
    return registry.spec_for(str(kind_or_spec), **params)


def _rmi_plan(spec: IndexSpec, n: int) -> tuple:
    """``(b, root_type)`` of an RMI-family spec for a table of ``n`` keys,
    as ``build_rmi`` / ``build_sy_rmi`` resolve them."""
    if spec.kind == "RMI":
        return max(2, min(spec.b, n)), spec.root_type
    if spec.kind == "SY-RMI":
        budget = spec.space_pct / 100.0 * n * 8
        return max(2, min(int(budget * spec.ub), n)), spec.winner_root
    raise ValueError(f"kind {spec.kind!r} is not RMI-family (no leaf-stage plan)")


# ---------------------------------------------------------------------------
# The batched fits: one device pass for a batch, host assembly per member
# ---------------------------------------------------------------------------


def _check_same_length(tables) -> int:
    n = len(tables[0])
    if any(len(t) != n for t in tables):
        raise ValueError("fit='vmap' needs same-length tables (pad first — see build_many)")
    return n


def _stacked_f64(tables, dev) -> torch.Tensor:
    """The tables' keys as one ``(N, n)`` f64 stack on ``dev``, each key
    correctly rounded (:func:`repro_torch.core.keys.to_f64`)."""
    return keymod.to_f64(keymod.encode(np.stack(tables), dev))


def _normalize_many(tables, kmin, inv_span, dev) -> torch.Tensor:
    """``u`` of every table in one pass, the expression of ``build_rmi`` and
    the query path: subtract, then multiply by the reciprocal (a divide
    could flip a boundary key's leaf)."""
    u = (_stacked_f64(tables, dev) - torch.from_numpy(kmin).to(dev)[:, None]) * \
        torch.from_numpy(inv_span).to(dev)[:, None]
    return torch.clamp(u, 0.0, 1.0)


def _leaf_fit_many(u, root_coefs, b: int):
    """The leaf fit of every table of the stack in one pass, to the host."""
    return [a.cpu().numpy() for a in rmi_leaf_fit(u, root_coefs, b)]


def _vmap_fit_rmi(specs: list, tables: list, dev) -> list:
    """Batched RMI-family build: host root fits (tiny), one device leaf
    fit for the batch, host assembly of each model (the kernel's f32
    re-encoding included).  Every member must resolve to one branching
    factor and one table length."""
    sw = stopwatch()
    _check_same_length(tables)
    plans = [_rmi_plan(spec, len(t)) for spec, t in zip(specs, tables)]
    bs = {b for b, _ in plans}
    if len(bs) != 1:
        raise ValueError(f"a batched leaf fit needs one branching factor, got {sorted(bs)}")
    b = bs.pop()
    roots = [fit_root(t, root_type) for t, (_, root_type) in zip(tables, plans)]
    root_coefs = np.stack([rc for rc, _, _ in roots])
    kmin = np.asarray([km for _, km, _ in roots], dtype=np.float64)
    inv_span = np.asarray([iv for _, _, iv in roots], dtype=np.float64)
    u = _normalize_many(tables, kmin, inv_span, dev)
    slopes, icepts, eps, r = _leaf_fit_many(u, torch.from_numpy(root_coefs).to(dev), b)
    per_model_s = sw.elapsed / len(tables)  # the batch's time, shared
    out = []
    for i, (spec, t, (_, root_type)) in enumerate(zip(specs, tables, plans)):
        m = assemble_rmi(t, root_type, root_coefs[i], kmin[i], inv_span[i], slopes[i], icepts[i],
                         eps[i], r[i], build_time=per_model_s)
        extra = None
        if spec.kind == "SY-RMI":
            m.name = f"SY-RMI[{spec.space_pct}%]"
            extra = {"space_pct": spec.space_pct}
        out.append(impls._rmi_to_index(m, t, extra))
    return out


def _masks_pgm_scan(keys, eps_np):
    return pgm_segments_scan(keys, torch.from_numpy(eps_np).to(keys.device)).cpu().numpy()


def _masks_rs_scan(keys, eps_np):
    return rs_knots_scan(keys, torch.from_numpy(eps_np).to(keys.device)).cpu().numpy()


def _fast_masks(keys, eps_np, fast_fit, scan_masks, kind: str):
    """The fast fit's masks with the verified-ε fallback: the members whose
    re-measure failed (``ok`` False) are re-fit with the exact scan, decided
    on the host after the fast launch, so the fast pass never runs the
    O(n)-depth walk."""
    masks, oks = fast_fit(keys, torch.from_numpy(eps_np).to(keys.device))
    masks, oks = masks.cpu().numpy(), oks.cpu().numpy()
    if not oks.all():
        bad = np.flatnonzero(~oks)
        metric("fit_fast_fallbacks").inc(len(bad), kind=kind)
        masks[bad] = scan_masks(keys[torch.from_numpy(bad).to(keys.device)], eps_np[bad])
    return masks


def _masks_pgm_fast(keys, eps_np):
    return _fast_masks(keys, eps_np, pgm_fit_fast, _masks_pgm_scan, "PGM")


def _masks_rs_fast(keys, eps_np):
    return _fast_masks(keys, eps_np, rs_knots_fast, _masks_rs_scan, "RS")


def _pgm_model_from_mask(table, eps: int, mask):
    """One PGMModel of a level-0 start mask: the slopes from the mask
    (bit-identical to the greedy's, :func:`segment_slopes`), the upper
    levels recursed on the host (~n/2ε segment keys)."""
    starts = np.flatnonzero(mask)
    slopes = segment_slopes(table.astype(np.float64), starts, eps)
    return build_pgm(table, eps=eps, l0=(starts, slopes))


def _pgm_space_of_mask(table, eps: int, mask) -> int:
    """``PGMModel.space_bytes()`` of :func:`_pgm_model_from_mask` without
    its level-0 slopes: the bi-criteria search reads only the level sizes."""
    starts = np.flatnonzero(mask)
    sizes = [len(starts)]
    keys = table.astype(np.float64)[starts]
    while sizes[-1] > 1:
        starts = pla_segments(keys, eps)[0]
        sizes.append(len(starts))
        keys = keys[starts]
    return sum(sizes) * 24 + 16


def _vmap_fit_pgm(specs: list, tables: list, dev, *, masks_fn=_masks_pgm_scan) -> list:
    """Batched PGM build: one corridor-scan launch for the batch's level-0
    segmentation (per-member ε), host assembly; bit-exact with the
    registered builder.  ``masks_fn`` swaps in the fast fit."""
    _check_same_length(tables)
    eps = np.asarray([max(int(s.eps), 1) for s in specs], dtype=np.float64)
    masks = masks_fn(_stacked_f64(tables, dev), eps)
    return [impls._pgm_to_index(_pgm_model_from_mask(t, int(e), mask), t)
            for t, e, mask in zip(tables, eps, masks)]


def _vmap_fit_pgm_bicriteria(specs: list, tables: list, dev, *, masks_fn=_masks_pgm_scan) -> list:
    """Batched bi-criteria PGM: :func:`~repro_torch.core.pgm.build_pgm_bicriteria`'s
    per-member ε bisection in lockstep, each step's segmentations one
    corridor-scan launch for every member.  The decisions read the same
    ``space_bytes`` of the same segmentations as the host build, so the
    chosen ε and the leaves match it; each member's model is assembled once,
    from the mask of its chosen ε."""
    _check_same_length(tables)
    keys = _stacked_f64(tables, dev)
    n_members = len(specs)
    lo, hi = [], []
    best = [None] * n_members  # (eps, mask) of the smallest ε within budget
    for spec, t in zip(specs, tables):
        eps_m, eps_M = bicriteria_eps_bounds(len(t), spec.a)
        lo.append(eps_m)
        hi.append(eps_M)

    def step_masks(eps_by_member: dict):
        eps_all = np.asarray([float(eps_by_member.get(i, 1)) for i in range(n_members)])
        masks = masks_fn(keys, eps_all)
        return {i: masks[i] for i in eps_by_member}

    for _ in range(BICRITERIA_MAX_ITERS):
        mids = {i: (lo[i] + hi[i]) // 2 for i in range(n_members) if lo[i] <= hi[i]}
        if not mids:
            break
        for i, mask in step_masks(mids).items():
            if _pgm_space_of_mask(tables[i], mids[i], mask) <= specs[i].budget_for(len(tables[i])):
                if best[i] is None or mids[i] < best[i][0]:
                    best[i] = (mids[i], mask)
                hi[i] = mids[i] - 1  # try a smaller eps (bigger model)
            else:
                lo[i] = mids[i] + 1
    missing = {i: bicriteria_eps_bounds(len(tables[i]), specs[i].a)[1]
               for i in range(n_members) if best[i] is None}
    for i, mask in (step_masks(missing) if missing else {}).items():
        best[i] = (missing[i], mask)
    out = []
    for i, spec in enumerate(specs):
        m = _pgm_model_from_mask(tables[i], *best[i])
        m.name = f"PGM_M_{spec.a}[eps={m.eps}]"
        out.append(impls._pgm_to_index(m, tables[i], {"a": spec.a}))
    return out


def _vmap_fit_rs(specs: list, tables: list, dev, *, masks_fn=_masks_rs_scan) -> list:
    """Batched RadixSpline build: one corridor-scan launch for the batch's
    knots (per-member ε), host assembly (radix table, verified ε) —
    bit-exact with the registered builder.  ``masks_fn`` swaps in the fast
    knots (``eps_eff`` is re-measured from the knots either way)."""
    _check_same_length(tables)
    eps = np.asarray([int(s.eps) for s in specs], dtype=np.float64)
    masks = masks_fn(_stacked_f64(tables, dev), eps)
    return [impls._rs_to_index(build_rs(t, eps=spec.eps, r_bits=spec.r_bits,
                                        knots=np.flatnonzero(mask)), t)
            for spec, t, mask in zip(specs, tables, masks)]


#: kind -> batched device fit (all members share the kind)
_VMAP_FITS = {
    "RMI": _vmap_fit_rmi,
    "SY-RMI": _vmap_fit_rmi,
    "PGM": _vmap_fit_pgm,
    "PGM_M": _vmap_fit_pgm_bicriteria,
    "RS": _vmap_fit_rs,
}

#: kind -> batched O(log n) fit: the corridor fits with the fast masks
_FAST_FITS = {
    "PGM": partial(_vmap_fit_pgm, masks_fn=_masks_pgm_fast),
    "PGM_M": partial(_vmap_fit_pgm_bicriteria, masks_fn=_masks_pgm_fast),
    "RS": partial(_vmap_fit_rs, masks_fn=_masks_rs_fast),
}


def _vmap_fit(specs: list, tables: list, dev) -> list:
    kind = specs[0].kind
    fit_fn = _VMAP_FITS.get(kind)
    if fit_fn is None:
        raise ValueError(
            f"fit='vmap' is not supported for kind {kind!r}: it has no batched device fit "
            f"(vmappable kinds: {VMAP_KINDS}); use fit='auto' to fit those on the device and "
            "build the others on the host"
        )
    return fit_fn(specs, tables, dev)


def _fast_fit(specs: list, tables: list, dev) -> list:
    kind = specs[0].kind
    fit_fn = _FAST_FITS.get(kind)
    if fit_fn is None:
        raise ValueError(
            f"fit='fast' is not supported for kind {kind!r}: it has no O(log n) "
            f"corridor fit (fast kinds: {FAST_KINDS}); use fit='vmap' or 'auto'"
        )
    return fit_fn(specs, tables, dev)


def _is_pgm(kind: str) -> bool:
    return registry.entry(kind).query_key == "pgm"


class BatchedIndexes:
    """N same-spec indexes over N tables, stacked leaf-wise.

    index:   stacked :class:`Index`: every leaf has a leading table axis.
    tables:  ``(N, m)`` encoded int64 keys, each table padded to a common
             power-of-two ``m`` (strictly increasing continuation).
    counts:  ``(N,)`` int64: valid (unpadded) keys per table.
    meta:    per-table host metadata (original statics, harmonized leaf
             shapes, build info) behind a bit-exact :meth:`unstack`.
    """

    __slots__ = ("index", "tables", "counts", "meta", "info")

    def __init__(self, index: Index, tables, counts, meta, info=None):
        object.__setattr__(self, "index", index)
        object.__setattr__(self, "tables", tables)
        object.__setattr__(self, "counts", counts)
        object.__setattr__(self, "meta", list(meta))
        object.__setattr__(self, "info", dict(info or {}))

    @property
    def n_tables(self) -> int:
        return len(self.meta)

    @property
    def kind(self) -> str:
        return self.index.kind

    @property
    def device(self) -> torch.device:
        return self.index.device

    def __repr__(self):
        return (
            f"BatchedIndexes(kind={self.kind!r}, n_tables={self.n_tables}, "
            f"m={int(self.tables.shape[1])})"
        )

    def unstack(self) -> list:
        """The per-table indexes, bit-exact with per-table builds (the PGM
        level lift inverted)."""
        lifted = self.index.s("levels") if _is_pgm(self.kind) else 0
        stacked = self.index.to_numpy()
        out = []
        for i, m in enumerate(self.meta):
            arrays = {
                k: v[i][tuple(slice(0, int(s)) for s in m["shapes"][k])]
                for k, v in stacked.items()
            }
            if lifted:
                arrays = _lower_pgm_arrays(arrays, lifted, dict(m["static"])["levels"])
            out.append(Index.from_numpy(self.kind, m["static"], arrays, m.get("info"),
                                        device=self.device))
        return out

    def queries_for(self, queries) -> torch.Tensor:
        """``queries`` as encoded ``(N, B)`` int64 on the batch's device: a
        ``(B,)`` batch (uint64 numpy or an encoded tensor) is broadcast to
        every table with ``expand``, without a copy."""
        q = keymod.as_keys(queries, self.device)
        if q.dim() == 1:
            q = q[None, :].expand(self.n_tables, q.shape[0])
        elif q.dim() != 2 or q.shape[0] != self.n_tables:
            raise ValueError(f"expected (B,) or ({self.n_tables}, B) queries, got {tuple(q.shape)}")
        return q

    def lookup(self, queries, *, backend: str = "kernel") -> torch.Tensor:
        """Predecessor ranks per table, ``(N, B)`` int64 on the batch's
        device, for ``(N, B)`` queries or one ``(B,)`` batch broadcast to
        every table.  ``backend="kernel"`` is one launch of the kind's
        batched kernel; a backend the kind does not claim (GAPPED's
        ``"kernel"``) raises ``ValueError``."""
        if backend not in BATCH_BACKENDS:
            raise ValueError(f"unknown batched backend {backend!r}; choose from {BATCH_BACKENDS}")
        check_backend(self.kind, backend)
        r = lookup_impl(self.index, self.tables, self.queries_for(queries), backend)
        # hits in the padded tail clamp back to the last real key
        return torch.minimum(r, self.counts[:, None] - 1)

    def space_bytes(self) -> int:
        """Summed per-table model bytes."""
        return sum(i.space_bytes() for i in self.unstack())


def _lower_pgm_arrays(arrays: dict, lifted: int, target: int) -> dict:
    """Invert the PGM level lift of :mod:`repro_torch.dist.sharded_index`:
    strip the ``lifted - target`` synthetic one-segment root levels and
    re-pad, which gives the original build's leaves bit for bit."""
    extra = lifted - target
    if extra == 0:
        return arrays
    if extra < 0:
        raise ValueError(f"cannot lower {lifted} levels to {target}: not lifted")
    sizes = np.asarray(arrays["sizes"])
    if not (sizes[:extra] == 1).all():
        raise ValueError("leading levels are not synthetic one-segment roots")
    kv = int(sizes.sum())
    rv = int((sizes + 1).sum())
    out = dict(arrays)
    out.update(_pgm_level_arrays(
        arrays["keys"][:kv][extra:],
        arrays["slope"][:kv][extra:],
        arrays["rank0"][:rv][2 * extra:],
        arrays["pk_u0"][:kv][extra:],
        arrays["pk_slope"][:kv][extra:],
        sizes[extra:].astype(np.int64),
    ))
    return out


def build_many(kind_or_spec, tables, *, fit: str = "host", device=None, **params) -> BatchedIndexes:
    """Build one index per table and stack them into a
    :class:`BatchedIndexes` on ``device`` (default: the card; pass
    ``device="cpu"`` for the CPU).

    ``tables`` are sorted uint64 numpy arrays.  Same-length tables build
    as they are, so with ``fit="host"`` :meth:`~BatchedIndexes.unstack` is
    bit-exact with per-table ``build``; ragged batches are padded to a
    common power-of-two length first (the tier idiom), and lookups clamp
    back to each table's real keys.  ``fit`` picks the strategy (module
    docstring): ``"vmap"`` and ``"fast"`` fit on ``device`` and raise for a
    kind without such a fit, ``"auto"`` is ``"vmap"`` where it applies.
    Example::

        bm = build_many(RMISpec(b=1024), [t0, t1, t2], fit="auto")
        ranks = bm.lookup(queries)              # (3, B), one launch
        per_table = bm.unstack()
        bm = build_many(PGMSpec(eps=32), [t0, t1], fit="fast")  # ranks exact
    """
    if fit not in FITS:
        raise ValueError(f"unknown fit {fit!r}; choose from {FITS}")
    dev = resolve_device(device)
    spec = _resolve_spec(kind_or_spec, **params)
    tables = [np.asarray(t, dtype=np.uint64) for t in tables]
    if not tables:
        raise ValueError("need at least one table")
    counts = np.asarray([len(t) for t in tables], dtype=np.int64)
    if len(set(counts.tolist())) == 1:
        fit_tables = tables  # equal lengths: no padding, bit-exact with build()
    else:
        m = _pow2ceil(int(counts.max()))
        fit_tables = [_pad_sorted_table(t, m) for t in tables]
    entry = registry.entry(spec.kind)
    if fit == "fast":
        per = _fast_fit([spec] * len(fit_tables), fit_tables, dev)
    elif fit == "vmap" or (fit == "auto" and spec.kind in VMAP_KINDS):
        per = _vmap_fit([spec] * len(fit_tables), fit_tables, dev)
    else:
        per = [entry.build(spec, t) for t in fit_tables]
    return _stack_with_meta(spec, per, fit_tables, counts, dev)


def _stack_with_meta(spec: IndexSpec, per: list, fit_tables: list, counts, dev) -> BatchedIndexes:
    """Harmonize and stack host builds ``(static, arrays, info)`` and move
    the stacked leaves, tables and counts to ``dev``."""
    per = [(tuple((str(k), int(v)) for k, v in s), {k: np.asarray(v) for k, v in a.items()}, i)
           for s, a, i in per]
    harmonized = _harmonize(spec.kind, [(s, a) for s, a, _ in per])
    static, arrays = stack_arrays(harmonized)
    name = per[0][2].get("name", spec.kind)
    index = Index.from_numpy(spec.kind, static, arrays,
                             {"n_shards": len(per), "name": f"sharded-{name}"}, device=dev)
    meta = [
        {"static": s, "shapes": {k: tuple(v.shape) for k, v in ha.items()}, "info": dict(i)}
        for (s, _, i), (_, ha) in zip(per, harmonized)
    ]
    info = {"spec": spec.display_name(), "n_tables": len(fit_tables), "m": len(fit_tables[0])}
    return BatchedIndexes(
        index=index,
        tables=keymod.encode(np.stack(fit_tables), dev),
        counts=torch.from_numpy(counts).to(dev),
        meta=meta,
        info=info,
    )


def build_grid(specs, table_np, *, fit: str = "auto", device=None) -> list:
    """One :class:`Index` per spec over one sorted uint64 table, in spec
    order, on ``device`` (default: the card).

    Under ``fit="auto"``/``"vmap"``, RMI-family entries that resolve to one
    branching factor (every root type at one ``b``) share one leaf fit, and
    the PGM / PGM_M / RS entries of a kind one corridor-scan launch (ε is a
    per-member input); a lone entry and every other kind take the host
    build.  ``fit="fast"`` takes the fast fits for those three kinds, even
    for a lone entry.  Example::

        specs = [RMISpec(b=512, root_type=r) for r in ("linear", "cubic")]
        specs += [PGMSpec(eps=e) for e in (16, 32, 64)] + [RSSpec(eps=32)]
        built = build_grid(specs, table)        # spec order kept
        sizes = [idx.space_bytes() for idx in built]
    """
    if fit not in FITS:
        raise ValueError(f"unknown fit {fit!r}; choose from {FITS}")
    dev = resolve_device(device)
    specs = [_resolve_spec(s) for s in specs]
    table_np = np.asarray(table_np, dtype=np.uint64)
    n = len(table_np)
    out: dict = {}
    groups: dict = {}
    if fit in ("auto", "vmap", "fast"):
        for i, spec in enumerate(specs):
            if spec.kind in ("RMI", "SY-RMI"):
                groups.setdefault(("rmi", _rmi_plan(spec, n)[0]), []).append((i, spec))
            elif spec.kind in VMAP_KINDS:
                groups.setdefault((spec.kind,), []).append((i, spec))
    for key, members in groups.items():
        use_fast = fit == "fast" and key[0] in FAST_KINDS
        if len(members) < 2 and not use_fast:
            continue  # a lone entry gains nothing from the batch
        fit_fn = _fast_fit if use_fast else _vmap_fit
        built = fit_fn([s for _, s in members], [table_np] * len(members), dev)
        for (i, spec), per in zip(members, built):
            out[i] = Index.from_numpy(spec.kind, *per, device=dev)
    for i, spec in enumerate(specs):
        if i not in out:
            out[i] = Index.from_numpy(spec.kind, *registry.entry(spec.kind).build(spec, table_np),
                                      device=dev)
    return [out[i] for i in range(len(specs))]


__all__ = ["BATCH_BACKENDS", "FAST_KINDS", "FITS", "VMAP_KINDS", "BatchedIndexes", "build_grid",
           "build_many"]
