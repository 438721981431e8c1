"""Work-efficient scans and reductions along the last axis, over power-of-two
lane counts (counterpart of `bls12_381_tpu/utils/scans.py`), and the
Straus engine of the windowed scalar multiplications with its per-lane
table lookup.

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


def tree_unflatten(like, leaves):
    """A nested tuple shaped like `like` from its leaves, in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def stack_table(entries) -> torch.Tensor:
    """Equally nested entries ([L, *batch] leaves, broadcast to one shape)
    -> one table tensor [n_entries, n_leaves, L, *batch]."""
    leaves = [tree_leaves(e) for e in entries]
    shape = torch.broadcast_shapes(*[t.shape for e in leaves for t in e])
    return torch.stack([torch.stack([t.expand(shape) for t in e])
                        for e in leaves])


def take_entry(table: torch.Tensor, index: torch.Tensor, like):
    """Entry index[b] of a `stack_table` table on each lane b, nested like
    `like`: one gather over the whole table."""
    idx = index.long().reshape((1, 1, 1) + tuple(index.shape)).expand(
        (1,) + table.shape[1:])
    return tree_unflatten(like, torch.gather(table, 0, idx)[0].unbind(0))


def straus(points, digits_list, n_entries: int, identity, add,
           double_window, neg_select=None):
    """sum_i [k_i] P_i with shared doublings (Straus windows) in any group
    given by its operations: per point a table of identity, P, ...,
    (n_entries - 1) P built by successive adds, then per digit step (MSB
    first) one `double_window` of the accumulator and, per point, one add
    of its digit's entry.  digits_list holds (digits, negs) per point,
    [n_digits, *batch] each; where negs is not None, neg_select(negs[s],
    entry) negates the entry of a negative digit.  Shorter digit lists are
    left-padded with zero digits; identity() is the identity at the
    points' batch shape."""
    tables = []
    for p in points:
        entries = [identity(), p]
        for _ in range(2, n_entries):
            entries.append(add(entries[-1], p))
        tables.append(stack_table(entries))
    n_steps = max(d.shape[0] for d, _ in digits_list)

    def pad(d):
        if d is None or d.shape[0] == n_steps:
            return d
        return torch.cat([d.new_zeros((n_steps - d.shape[0],) + d.shape[1:]),
                          d])

    digits_list = [(pad(d), pad(ng)) for d, ng in digits_list]
    acc = identity()
    for s in range(n_steps):
        acc = double_window(acc)
        for table, (digits, negs) in zip(tables, digits_list):
            entry = take_entry(table, digits[s], points[0])
            if negs is not None:
                entry = neg_select(negs[s], entry)
            acc = add(acc, entry)
    return acc


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
