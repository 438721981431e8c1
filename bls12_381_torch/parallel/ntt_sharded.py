"""The radix-2 NTT over Fr as a four-step over the ranks of a mesh.

Counterpart of `bls12_381_tpu/parallel/ntt_sharded.py`.  N = n1 n2 is
viewed as an [n1, n2] matrix, input index j = j1 n2 + j2, its columns
sharded over the mesh (n2 / c per rank):

  1. a local NTT of length n1 down each of this rank's columns;
  2. the outer twiddle: entry (k1, j2) times omega_N^(k1 j2), this rank's
     block of a table built on the device and cached;
  3. the transpose: ONE all_to_all_single sends rows k1 of block r to rank
     r, so that each rank holds all of n2 for n1 / c rows;
  4. a local NTT of length n2 along each of those rows;
  5. for the inverse the 1/N scaling (on the rank's own rows, before the
     gather: the same values as the JAX package's scaling after it), then
     one all_gather into natural order, k = k2 n1 + k1.

The local NTTs are `ops.ntt.ntt` with the scaling skipped; every launch is
the port's `butterfly` or `sop_fr` kernel (the row kernel) on a CUDA
tensor, their plain versions on a CPU tensor.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from .. import params
from ..fields import fr
from ..ops.ntt import ntt
from . import mesh as mesh_mod


def split(n: int, ranks: int) -> tuple[int, int]:
    """(n1, n2) of the four-step for N = n over `ranks` ranks: n2 =
    2^max(ceil(log2 N / 2), bits(ranks - 1)), as the JAX package picks it;
    both sides must divide evenly over the ranks."""
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    n2 = 1 << max((log_n + 1) // 2, (ranks - 1).bit_length())
    n1 = n // n2
    if n1 < 1 or n1 % ranks or n2 % ranks:
        raise ValueError(f"an NTT of {n} points splits into [{n1}, {n2}], "
                         f"which does not shard over {ranks} ranks")
    return n1, n2


def _build_twiddles(n1: int, n2: int, inverse: bool,
                    device) -> torch.Tensor:
    """omega_N^(k1 i2) as Montgomery [16, n1, n2]: row k1's base omega^k1
    from the host, then log2(n2) doublings of the columns on the device
    (two Fr products each), as the JAX package builds it."""
    n = n1 * n2
    root = pow(params.FR_ROOT_OF_UNITY, 1 << (params.FR_S - n.bit_length()
                                              + 1), params.Q)
    if inverse:
        root = pow(root, params.Q - 2, params.Q)
    base = fr.from_ints([pow(root, k1, params.Q) for k1 in range(n1)],
                        device=device)
    powers = fr.one((n1, 1), device=device)  # base^0
    step = base[:, :, None]  # base^width
    width = 1
    while width < n2:
        take = min(width, n2 - width)
        powers = torch.cat([powers, fr.mul(powers[..., :take], step)], -1)
        step = fr.mul(step, step)
        width *= 2
    return powers[..., :n2]


@functools.lru_cache(maxsize=8)
def _twiddles_cached(n1: int, n2: int, inverse: bool,
                     device: torch.device) -> torch.Tensor:
    return _build_twiddles(n1, n2, inverse, device)


def ntt_sharded(mesh, coeffs: torch.Tensor,
                inverse: bool = False) -> torch.Tensor:
    """NTT of [16, N] Montgomery coefficients (the same on every rank) over
    the mesh; returns the transform [16, N] in natural order on every
    rank."""
    if coeffs.dim() != 2:
        raise ValueError(f"ntt_sharded takes [16, N], got "
                         f"{tuple(coeffs.shape)}")
    limbs, n = coeffs.shape
    c = mesh.size()
    n1, n2 = split(n, c)
    w, m = n2 // c, n1 // c
    cols = slice(dist.get_rank() * w, (dist.get_rank() + 1) * w)
    table = _twiddles_cached(n1, n2, inverse, coeffs.device)

    # 1-2. this rank's columns as rows [16, w, n1]; NTT down them, twiddle
    x = coeffs.reshape(limbs, n1, n2)[:, :, cols].movedim(1, 2)
    y = fr.mul(ntt(x, inverse, _skip_scale=True),
               table[:, :, cols].movedim(1, 2))
    # 3. rows k1 of block r to rank r: [c, 16, w, m] out, the same in
    recv = mesh_mod.all_to_all(y.reshape(limbs, w, c, m).permute(2, 0, 1, 3))
    # [16, m, n2] with j2 = (sending rank) w + j2_local
    y = recv.permute(1, 3, 0, 2).reshape(limbs, m, n2)
    # 4. NTT along the rows
    z = ntt(y, inverse, _skip_scale=True)
    if inverse:
        z = fr.mul(z, fr.const(pow(n, params.Q - 2, params.Q), z.shape[1:],
                               device=z.device))
    # 5. rows k1 of every rank, then k = k2 n1 + k1
    z = mesh_mod.gather_batch(z, dim=1)  # [16, n1, n2]
    return z.transpose(1, 2).reshape(limbs, n)
