"""Radix-2 NTT over the scalar field Fr (counterpart of
`bls12_381_tpu/ops/ntt.py`).

Iterative Cooley-Tukey over [16, *batch, N] Montgomery limbs (N a power of
two), step by step as the JAX package does it:

  - the twiddle table root^j, j < N/2, built on the device by doubling:
    log2(N/2) Fr products (`sop_fr` launches) against per-step constants;
  - the bit-reversal gather;
  - log2(N) stages, each ONE fused butterfly over N/2 lanes (one
    `butterfly` launch) with the stage's table `master[:, ::N/m]` tiled;
  - for the inverse, the 1/N scaling (one more `sop_fr` launch).

Twiddles are rebuilt on every call, as in the JAX package.
"""

from __future__ import annotations

import torch

from .. import params
from ..fields import fr


def _master_twiddles(log_n: int, inverse: bool, device) -> torch.Tensor:
    """Powers root^j, j in [0, N/2), as [16, N/2] on the device, by
    doubling: stage s (s = 1..log_n) needs omega_{2^s}^j = root^(j N/2^s)
    for j < 2^(s-1), the stride-(N/2^s) subset of this table."""
    n = 1 << log_n
    root = pow(params.FR_ROOT_OF_UNITY, 1 << (params.FR_S - log_n), params.Q)
    if inverse:
        root = pow(root, params.Q - 2, params.Q)
    powers = fr.one((1,), device=device)
    width = 1
    while width < n // 2:
        step = fr.const(pow(root, width, params.Q), (1,), device=device)
        powers = torch.cat([powers, fr.mul(powers, step)], dim=-1)
        width *= 2
    return powers[:, :n // 2]


def _bit_reverse_perm(log_n: int, device) -> torch.Tensor:
    idx = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt(coeffs: torch.Tensor, inverse: bool = False,
        _skip_scale: bool = False) -> torch.Tensor:
    """In-order radix-2 NTT of an Fr batch [16, *batch, N].

    Forward: evaluates at omega^k in natural order.  With inverse=True,
    computes the inverse transform including the 1/N scaling, which
    _skip_scale suppresses for the sharded four-step
    (`parallel/ntt_sharded.py`), as in the JAX package."""
    n = coeffs.shape[-1]
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT size must be a power of two, got {n}")
    dev = coeffs.device
    master = _master_twiddles(log_n, inverse, dev)  # [16, N/2]
    extra = coeffs.dim() - 2  # batch dims between limbs and N
    lead = coeffs.shape[:-1]

    x = coeffs[..., _bit_reverse_perm(log_n, dev)]
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m // 2
        # stage table: stride-(n/m) subset of the master powers, tiled
        tw = master[:, ::n // m].repeat(1, n // m)  # [16, N/2]
        tw = tw.reshape(tw.shape[:1] + (1,) * extra + tw.shape[1:])
        # view as [16, *batch, n/m, m]; even/odd halves of each group
        xg = x.reshape(lead + (n // m, m))
        a = xg[..., :half].reshape(lead + (n // 2,))
        b = xg[..., half:].reshape(lead + (n // 2,))
        lo, hi = fr.butterfly(a, b, tw)
        x = torch.cat([lo.reshape(lead + (n // m, half)),
                       hi.reshape(lead + (n // m, half))],
                      dim=-1).reshape(lead + (n,))
    if inverse and not _skip_scale:
        n_inv = fr.const(pow(n, params.Q - 2, params.Q), x.shape[1:],
                         device=dev)
        x = fr.mul(x, n_inv)
    return x


def intt(evals: torch.Tensor) -> torch.Tensor:
    return ntt(evals, inverse=True)


def poly_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial product via the NTT (convolution theorem), sizes padded
    to the next power of two >= deg(a) + deg(b) + 1."""
    na, nb = a.shape[-1], b.shape[-1]
    n = 1 << (na + nb - 1).bit_length() if (na + nb - 1) & (na + nb - 2) \
        else na + nb - 1
    n = max(n, 2)
    pad_a = a.new_zeros(a.shape[:-1] + (n - na,))
    pad_b = b.new_zeros(b.shape[:-1] + (n - nb,))
    fa = ntt(torch.cat([a, pad_a], dim=-1))
    fb = ntt(torch.cat([b, pad_b], dim=-1))
    return intt(fr.mul(fa, fb))
