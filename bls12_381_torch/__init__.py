"""BLS12-381 in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch and CUDA port of `bls12_381_tpu` (which stays in the repository
as the reference), slice by slice; this slice is the batched optimal-ate
pairing.  Same numeric domain and boundary layout as the JAX package: a
field element batch is an int32 tensor [L, *batch] of 16-bit Montgomery limbs
(R = 2^384 for Fp), so values compare as plain arrays.

Layers:
  params, hostmath — constants and the host integer arithmetic they need
  limbs            — batched 16-bit-limb Montgomery arithmetic
  kernels          — CUDA kernels (sop, sqr, plan_exec) and plain versions
  fields           — Fp and the Fp2/Fp6/Fp12 tower
  curves           — the G2 generator
  pairing          — G2 preparation, Miller loop, final exponentiation
  convert          — arrays of the JAX package <-> the port's tensors
  entry            — `entry()`: the pairing and example inputs

A tensor on a CUDA device goes through the kernels; a CPU tensor through
their plain PyTorch versions.  Entry points default to `device="cuda"`.
"""

__version__ = "0.1.0"
