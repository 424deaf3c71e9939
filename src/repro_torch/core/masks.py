"""General-recursion masks (Supp. C.1, recursion (9), D > 1), the port's
copy of ``repro.core.masks``.

Each client applies a diagonal 0/1 "filter" S_u^ξ to its gradient: the
model coordinates are partitioned into D near-equal groups; per iteration
one group u is drawn uniformly and only those coordinates are computed,
updated, and TRANSMITTED — cutting per-round communication by ~D at the
cost of gradient sparsification.  The correction factor d_ξ = D keeps the
update unbiased: d_ξ E[S_u^ξ | ξ] = D_ξ (equation (10)).
"""
from __future__ import annotations

import torch

from repro_torch import prng, tree

F32 = torch.float32


def make_partition(params_template, D: int, *, seed: int = 0):
    """Partition the flattened coordinate space into D near-equal groups.

    Returns a tree of int32 leaves with values in [0, D) — the group id
    of every coordinate, the reference's bit for bit: leaf ``idx`` (jax's
    leaf order) takes ``tile(arange(D))[permutation(fold_in(PRNGKey(seed),
    idx), n)]``, drawn on the leaf's device.
    """
    key = prng.PRNGKey(seed)
    out = []
    for idx, leaf in enumerate(tree.leaves(params_template)):
        n = leaf.numel()
        perm = prng.permutation(prng.fold_in(key, idx), n,
                                device=leaf.device)
        out.append((perm % D).to(torch.int32).reshape(leaf.shape))
    return tree.unflatten(params_template, out)


def mask_for_group(partition, u: int):
    """Boolean mask tree selecting group u."""
    return tree.tree_map(lambda g: g == u, partition)


def apply_masked_update(grad, partition, u: int, D: int):
    """d_ξ · S_u^ξ ∇f  — the masked, unbiasedness-corrected update."""
    return tree.tree_map(
        lambda g, part: torch.where(part == u, D * g.to(F32),
                                    0.0).to(g.dtype),
        grad, partition)


def masked_update_nbytes(update, partition, u: int) -> int:
    """Bytes a client actually transmits (masked coordinates only)."""
    total = 0
    for g, part in zip(tree.leaves(update), tree.leaves(partition)):
        total += int((part == u).sum()) * g.element_size()
    return total


def expectation_check(grad, partition, D: int):
    """E_u[d S_u g] over the uniform u — should equal g exactly."""
    acc = tree.tree_map(torch.zeros_like, grad)
    for u in range(D):
        upd = apply_masked_update(grad, partition, u, D)
        acc = tree.tree_map(lambda a, b: a + b.to(a.dtype) / D, acc, upd)
    return acc
