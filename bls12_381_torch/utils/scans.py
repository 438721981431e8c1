"""Work-efficient scans and reductions along the last axis, over power-of-two
lane counts (counterpart of `bls12_381_tpu/utils/scans.py`).

`xs` is a tensor or a nested tuple of tensors (a field element, a point)
whose leaves share the last axis.  Every combine runs at a power-of-two lane
count: the inputs are padded to a power of two and the pad sliced off.  An
inclusive scan's output at position i depends only on inputs 0..i, so the
pad's values do not matter.  The recursion is the JAX package's, so a scan
combines the same operands in the same order and gives the same values.
"""

from __future__ import annotations

import torch


def tree_map(fn, *trees):
    """fn over the leaves of equally nested tuples of tensors."""
    if isinstance(trees[0], (tuple, list)):
        return tuple(tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def tree_leaves(x) -> list:
    """The tensors of a nested tuple, in order."""
    if isinstance(x, (tuple, list)):
        return [t for part in x for t in tree_leaves(part)]
    return [x]


def _n_lanes(x) -> int:
    return tree_leaves(x)[0].shape[-1]


def _interleave(even, odd):
    """[..., k] x2 -> [..., 2k] with even at 0::2, odd at 1::2."""
    return tree_map(lambda e, o: torch.stack([e, o], dim=-1).reshape(
        e.shape[:-1] + (-1,)), even, odd)


def _lead(identity1, t):
    """The one-lane identity broadcast to t's leading shape."""
    return identity1.expand(t.shape[:-1] + (1,))


def inclusive_scan(combine, xs, identity1):
    """Inclusive scan of an associative `combine(left, right)` along the
    last axis.  identity1 has ONE lane and is a left unit of the combine.
    About 2n combined lanes, 2 log2 n combine calls."""
    n = _n_lanes(xs)
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        xs = tree_map(lambda t: torch.cat(
            [t, t[..., -1:].expand(t.shape[:-1] + (pow2 - n,))], dim=-1), xs)
    out = _scan_pow2(combine, xs, identity1)
    if pow2 != n:
        out = tree_map(lambda t: t[..., :n], out)
    return out


def _scan_pow2(combine, x, identity1):
    if _n_lanes(x) == 1:
        return x
    even = tree_map(lambda t: t[..., 0::2], x)
    odd = tree_map(lambda t: t[..., 1::2], x)
    ps = _scan_pow2(combine, combine(even, odd), identity1)
    # out[2k+1] = ps[k]; out[2k] = combine(ps[k-1], x[2k]) with ps[-1] = id
    shifted = tree_map(lambda i, t: torch.cat([_lead(i, t), t[..., :-1]],
                                              dim=-1), identity1, ps)
    return _interleave(combine(shifted, even), ps)


def suffix_scan(combine, xs, identity1):
    """Inclusive suffix scan (out[i] = fold of xs[i..n-1]); operands keep
    their input order, so `combine` need not commute."""
    rev = tree_map(lambda t: t.flip(-1), xs)
    out = inclusive_scan(lambda l, r: combine(r, l), rev, identity1)
    return tree_map(lambda t: t.flip(-1), out)


def tree_reduce(combine, xs, identity1):
    """Reduce the last axis to one lane (kept, size 1) with a halving tree,
    identity-padded to a power of two."""
    n = _n_lanes(xs)
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        xs = tree_map(lambda i, t: torch.cat(
            [t, i.expand(t.shape[:-1] + (pow2 - n,))], dim=-1), identity1, xs)
    while _n_lanes(xs) > 1:
        xs = combine(tree_map(lambda t: t[..., 0::2], xs),
                     tree_map(lambda t: t[..., 1::2], xs))
    return xs
