"""Trees of tensors as ``jax.tree_util`` walks them.

Parameters and train states are nests of dicts and lists of tensors.  Three things
depend on the order of its leaves: the f32 sum in ``step.global_norm``,
Adafactor's walk over its ``v`` tree and a checkpoint's ``leaf_<i>``
numbering.  So the port flattens as ``jax.tree_util`` does: dict keys
sorted, lists in order, depth first, and renders a leaf's path as JAX
does (``"['params']/['layers']/[0]/['w']"``), which lets a checkpoint
written by either package restore into the other.
"""

from __future__ import annotations

import numpy as np
import torch


def _children(node):
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten_with_paths(tree) -> tuple:
    """``(paths, leaves)`` in ``jax.tree_util.tree_flatten_with_path``'s
    order, each path rendered as ``"/".join(str(key))``."""
    paths, leaves = [], []

    def walk(node, prefix):
        kids = _children(node)
        if kids is None:
            paths.append("/".join(prefix))
            leaves.append(node)
            return
        for key, child in kids:
            walk(child, prefix + [key])

    walk(tree, [])
    return paths, leaves


def leaves(tree) -> list:
    return flatten_with_paths(tree)[1]


def unflatten(template, new_leaves):
    """A tree of ``template``'s structure (dict key order kept) holding
    ``new_leaves`` in flattened order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: None for k in node}
            for k in sorted(node):
                out[k] = build(node[k])
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def flatten_up_to(template, tree) -> list:
    """The subtrees of ``tree`` at ``template``'s leaf positions (the
    reference's ``treedef.flatten_up_to``)."""
    out = []

    def walk(node, other):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], other[k])
        elif isinstance(node, (list, tuple)):
            for a, b in zip(node, other, strict=True):
                walk(a, b)
        else:
            out.append(other)

    walk(template, tree)
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in ``tree``'s structure."""
    others = [flatten_up_to(tree, r) for r in rest]
    return unflatten(tree, [fn(*args) for args in zip(leaves(tree), *others)])


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bf16 comes back as its raw ``uint16`` bits
    (numpy has no bfloat16)."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def from_numpy(arr, device, dtype_name: str | None = None) -> torch.Tensor:
    """``arr`` as a tensor on ``device``.  A bfloat16 array (the
    reference's ``ml_dtypes`` array, its ``.npy`` form ``V2``, or the
    raw ``uint16`` bits :func:`to_numpy` gives when ``dtype_name`` is
    ``"bfloat16"``) comes back as ``torch.bfloat16``."""
    arr = np.asarray(arr)
    if dtype_name == "bfloat16" or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tree_from_numpy(tree, device):
    """A nest of numpy arrays (e.g. ``jax.tree.map(np.asarray, state)``)
    as tensors on ``device``, dicts and lists kept."""
    return tree_map(lambda a: from_numpy(a, device), tree)
