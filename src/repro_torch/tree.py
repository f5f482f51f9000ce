"""The few pytree helpers the port needs where the reference calls
``jax.tree.map``.

A tree here is what the reference's parameter and optimizer-state trees
are made of: dicts, lists and ``None`` (an empty subtree), with anything
else a leaf (a tensor, a numpy array, or a tuple that a mapped function
returned).
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf, like ``jax.tree.map``. The first tree
    drives the walk: each of ``rest`` is read at the same keys and
    indices, and where the first tree has a leaf, ``fn`` receives
    whatever the others hold there (a whole subtree, too: an Adafactor
    state's ``{"vr", "vc"}`` dict beside its parameter)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unzip(tree, n: int) -> tuple:
    """A tree whose leaves are ``n``-tuples → ``n`` trees."""
    return tuple(tree_map(lambda leaf, i=i: leaf[i], tree) for i in range(n))


def tree_paths(tree, prefix: str = "") -> dict:
    """``{"a/b/#0/c": leaf}``: each leaf under its path, in the checkpoint
    format's spelling (``/`` between keys, ``#i`` for a list index)."""
    if isinstance(tree, dict):
        return {p: leaf for k in sorted(tree) for p, leaf in
                tree_paths(tree[k], f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {p: leaf for i, v in enumerate(tree) for p, leaf in
                tree_paths(v, f"{prefix}#{i}/").items()}
    if tree is None:
        return {}
    return {prefix[:-1]: tree}
