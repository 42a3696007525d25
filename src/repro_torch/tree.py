"""The few pytree walks the LM trainer needs, over the port's parameter
trees: dicts, lists, tuples and NamedTuples of tensors.

The order is jax's: a dict's keys sorted, a list's or tuple's entries by
index, a NamedTuple's fields in declaration order; ``None`` is an empty
subtree and gives no leaf.  So ``leaves_with_names`` names each leaf as
the reference's checkpoint does (``repro/train/checkpoint.py``
``_flatten_with_names``): the keys, indices and field names on its path
joined by "/".
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    raise TypeError(type(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_names(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) for every leaf of ``tree`` in jax's order."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from leaves_with_names(
            child, f"{prefix}/{name}" if prefix else name)


# the layer groups the reference stacks along a leading (L, …) axis; a
# hybrid model's ``periods`` is a list of slots {"block": group, "mlp":
# group}
LAYER_GROUPS = ("attn", "mlp", "moe", "ssm", "enc_attn", "enc_mlp",
                "cross")


def map_layer_groups(params: dict, group: Callable, leaf: Callable) -> dict:
    """``params`` (an LM parameter tree in either layout: the port's,
    each layer group a list of L per-layer dicts, or the reference's, one
    {name: (L, …)} dict) with each layer group through ``group`` and each
    other entry through ``leaf``.  The one place the port knows which of
    its lists the reference stacks: ``group`` stacks or unstacks."""
    out = {}
    for k, v in params.items():
        if k in LAYER_GROUPS:
            out[k] = group(v)
        elif k == "periods":
            out[k] = [{"block": group(slot["block"]),
                       "mlp": group(slot["mlp"])} for slot in v]
        else:
            out[k] = leaf(v)
    return out


def stacked_groups(params: dict) -> List[List[int]]:
    """The positions in ``leaves(params)`` of each tensor the reference
    holds: a leaf on its own, or the L per-layer leaves of one name in a
    layer group (``attn/0/wq`` … ``attn/L-1/wq`` are the reference's one
    (L, …) ``attn/wq``).  Any other tree (no layer groups) gives each of
    its leaves on its own."""
    groups: List[List[int]] = []

    def group(layers):
        groups.extend([lp[k] for lp in layers] for k in sorted(layers[0]))

    map_layer_groups(unflatten_like(params, range(len(leaves(params)))),
                     group, lambda t: groups.extend([i] for i in leaves(t)))
    return groups


def leaves(tree) -> list:
    """The leaves of ``tree`` in jax's order."""
    return [leaf for _, leaf in leaves_with_names(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of each of
    ``rest``) in jax's order, keeping the structure; ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_names(fn: Callable, tree, *rest, prefix: str = ""):
    """``tree_map`` whose ``fn`` also takes each leaf's name (the
    "/"-joined path ``leaves_with_names`` gives it) first:
    ``fn(name, leaf, *rest_leaves)``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree, *rest)

    def sub(name, child, others):
        return tree_map_with_names(fn, child, *others, prefix=(
            f"{prefix}/{name}" if prefix else name))

    if isinstance(tree, dict):
        return {k: sub(str(k), tree[k], [r[k] for r in rest])
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(sub(f, getattr(tree, f),
                                [getattr(r, f) for r in rest])
                            for f in tree._fields))
    return type(tree)(sub(str(i), v, [r[i] for r in rest])
                      for i, v in enumerate(tree))


def unflatten_like(template, flat: list):
    """A tree of ``template``'s structure holding ``flat``'s leaves, in
    the order ``leaves(template)`` gives them."""
    it = iter(flat)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
