"""Entry points of the port's paths: the batched optimal-ate pairing and
the radix-2 NTT over Fr.

`entry()` mirrors `__graft_entry__.entry()` of the JAX package: it returns
the pairing function and example inputs e([i+1]G1, [2i+1]G2), i < batch, on
the device (the card unless the caller asks for the CPU).  `ntt_entry()`
returns the NTT and random coefficients at N = 2^log_n, as `bench.py`'s
`bench_ntt` times it.
"""

from __future__ import annotations

import torch

from . import hostmath as hm
from . import params
from .fields import fp, tower as tw
from .limbs import DTYPE, FR, resolve_device
from .ops import ntt
from .pairing import pairing


def tiny_pairing_inputs(batch: int, device="cuda"):
    """Affine batches P_i = [i+1]G1, Q_i = [2i+1]G2 on a device."""
    dev = resolve_device(device)
    phs = [hm.g1_mul(params.G1_GEN, i + 1) for i in range(batch)]
    qhs = [hm.g2_mul(params.G2_GEN, 2 * i + 1) for i in range(batch)]
    no_inf = torch.zeros((batch,), dtype=torch.bool, device=dev)
    p_aff = (fp.from_ints([p[0] for p in phs], device=dev),
             fp.from_ints([p[1] for p in phs], device=dev), no_inf)
    q_aff = (tw.fp2_from_ints([q[0] for q in qhs], device=dev),
             tw.fp2_from_ints([q[1] for q in qhs], device=dev), no_inf)
    return p_aff, q_aff


def entry(batch: int = 2, device="cuda"):
    """(fn, example_args): the batched pairing e(P_i, Q_i) and inputs."""
    return pairing, tiny_pairing_inputs(batch, device)


def ntt_inputs(log_n: int, batch=(), seed: int = 4, device="cuda"):
    """Random canonical Fr coefficients [16, *batch, 2^log_n], made on the
    device from a seeded `torch.Generator`: uniform 16-bit limbs with the
    top limb masked to 14 bits, so every value is < 2^254 < q (the
    distribution of `bench.py`'s `_rand_fr`).  Read as Montgomery limbs."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 1 << 16, (FR.n_limbs,) + tuple(batch) + (1 << log_n,),
                      generator=gen, device=dev, dtype=DTYPE)
    x[-1] &= 0x3FFF
    return x


def ntt_entry(log_n: int = 20, seed: int = 4, device="cuda"):
    """(fn, example_args): the forward NTT and one batch of coefficients."""
    return ntt.ntt, (ntt_inputs(log_n, seed=seed, device=device),)
