"""Validator public keys resident on the card, summed by index: the key
aggregation of BLS FastAggregateVerify (a port-only module; the JAX
package has none).

A consensus client holds every validator's public key in a cache for the
life of the process and, for each aggregate signature, sums the keys of
the set's attesting indices.  `KeyRegistry` is that cache on the card:

  register(compressed)      48-byte compressed keys -> which were taken;
                            decoded with the subgroup check
                            (`curves.g1.from_compressed_host`), the
                            identity and every invalid encoding refused
                            (KeyValidate at deposit time), the rest
                            appended in order
  aggregate(indices, offsets)
                            one sum a set: the keys of set s are
                            indices[offsets[s]:offsets[s + 1]]; one ragged
                            sum over every set's keys
                            (`ops.msm.segment_sums`, the MSM's bucket
                            accumulation: on a card the plan kernel's
                            fold, one mixed addition a key)

The keys are affine (x, y) Montgomery limbs [24, n], as the MSM's window
gathers read them, and the same keys packed point-major for the fold
(`plan_exec.pack_words`, 96 bytes a key, made in `register`).  The
additions are complete, so a set may hold a key twice or a key and its
negation: the sum is exact, the identity included.  Indices and offsets
come from the host (a block's attesting indices) and are checked there
before anything reads the table.

Spans (`utils/profiling.py`): `agg` over `aggregate`, `agg.gather` over
preparing the operands (the CPU's gather; nothing on a card, whose table
is packed), `agg.sum` over the sums; `kernels.AGGREGATES` counts the
calls, sets and keys, `kernels.BUCKETS` the sums.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import limbs
from ..curves import g1 as G1
from ..kernels import AGGREGATES
from ..kernels import plan_exec as pe
from ..limbs import FP
from ..utils import graphs, profiling
from . import msm

# keys decoded a launch sequence: the subgroup check's ~130 group-law
# launches each run 2^18 lanes, so the card, not dispatch, sets the pace
REGISTER_CHUNK = 1 << 18


class KeyRegistry:
    """A table of affine G1 public keys on `device`, appended to by
    `register` and read by `aggregate`."""

    def __init__(self, device="cuda"):
        self.device = limbs.resolve_device(device)
        empty = torch.empty((FP.n_limbs, 0), dtype=limbs.DTYPE,
                            device=self.device)
        self.xy = (empty, empty.clone())
        self.packed = pe.pack_words(self.xy)

    def __len__(self) -> int:
        return self.xy[0].shape[-1]

    def register(self, compressed) -> np.ndarray:
        """Append the valid keys of uint8 [n, 48] compressed encodings, in
        order; returns bool [n], true where a key was taken.  Refused: a
        malformed encoding, an x off the curve, a point outside G1 and the
        identity."""
        data = np.asarray(compressed, dtype=np.uint8)
        if data.ndim != 2 or data.shape[1] != 48:
            raise ValueError(f"expected compressed keys uint8 [n, 48], got "
                             f"an array of shape {data.shape}")
        taken, parts = [], []
        for lo in range(0, len(data), REGISTER_CHUNK):
            chunk = data[lo:lo + REGISTER_CHUNK]
            (x, y, _), valid = G1.from_compressed_host(chunk,
                                                       device=self.device)
            ok = valid & ~G1.flags(chunk)[1]
            keep = torch.from_numpy(np.flatnonzero(ok)).to(self.device)
            parts.append((x.index_select(-1, keep), y.index_select(-1, keep)))
            taken.append(ok)
        if parts:
            self.xy = tuple(torch.cat([t] + [p[i] for p in parts], -1)
                            for i, t in enumerate(self.xy))
            self.packed = torch.cat([self.packed] + [pe.pack_words(p)
                                                     for p in parts])
        return np.concatenate(taken) if taken else np.zeros(0, dtype=bool)

    @profiling.spanned("agg")
    @graphs.releasing
    def aggregate(self, indices, offsets):
        """The sum of each set's keys: indices int [K] into the table, the
        sets' keys back to back; offsets int [S + 1], offsets[0] = 0,
        non-decreasing, offsets[S] = K.  Returns (projective G1 points [S],
        bool [S] on the device: the set is non-empty); an empty set sums
        to the identity.  ValueError for offsets or indices out of
        range."""
        idx, off = self._checked(indices, offsets)
        n_sets = len(off) - 1
        AGGREGATES.calls += 1
        AGGREGATES.sets += n_sets
        AGGREGATES.keys += len(idx)
        dev = self.device
        filled_np = off[1:] > off[:-1]
        filled = torch.from_numpy(filled_np).to(dev)
        if len(idx) == 0:
            return G1.identity((n_sets,), dev), filled
        # key i's set: the number of sets that end at or before i
        sets = torch.searchsorted(torch.from_numpy(off[1:]).to(dev),
                                  torch.arange(len(idx), device=dev),
                                  right=True)
        apk = msm.segment_sums(G1, self.xy, torch.from_numpy(idx).to(dev),
                               sets, n_sets, stage="agg", packed=self.packed)
        return apk, filled

    def _checked(self, indices, offsets):
        """(indices, offsets) as int64 numpy arrays, each checked against
        the table and each other."""
        idx = np.asarray(indices)
        off = np.asarray(offsets)
        for name, a in (("indices", idx), ("offsets", off)):
            if a.ndim != 1 or not (a.size == 0
                                   or np.issubdtype(a.dtype, np.integer)):
                raise ValueError(f"{name} must be a 1-D integer array, got "
                                 f"{a.dtype} of shape {a.shape}")
        if off.size == 0 or off[0] != 0 or off[-1] != idx.size \
                or (np.diff(off) < 0).any():
            raise ValueError(f"offsets must run from 0 to {idx.size} "
                             f"without falling, got {off}")
        if idx.size and (idx.min() < 0 or idx.max() >= len(self)):
            raise ValueError(f"indices must lie in [0, {len(self)}), got "
                             f"[{idx.min()}, {idx.max()}]")
        return idx.astype(np.int64), off.astype(np.int64)
