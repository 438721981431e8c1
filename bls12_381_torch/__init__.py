"""BLS12-381 in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch and CUDA port of `bls12_381_tpu` (which stays in the repository
as the reference), slice by slice; the slices so far are the batched
optimal-ate pairing, the radix-2 NTT over the scalar field, the G1/G2
group law with Pippenger multi-scalar multiplication, and the batched
scalar multiplications of G1, G2 and Gt with the subgroup checks and
cofactor clearing.  Same numeric domain and boundary layout as the JAX
package: a field element batch is an int32 tensor [L, *batch] of 16-bit
Montgomery limbs (R = 2^384 for Fp, 2^256 for Fr), so values compare as
plain arrays.

Layers:
  params, hostmath — constants and the host integer arithmetic they need
                     (the host pairing gives Gt's generator)
  limbs            — batched 16-bit-limb Montgomery arithmetic
  kernels          — CUDA kernels (sop, sqr, fold_planned, plan_exec,
                     sop_fr, butterfly) and plain versions
  fields           — Fp, the Fp2/Fp6/Fp12 tower, Fr
  utils            — power-of-two scans and reductions, table lookups
  curves           — G1 and G2: the complete group law, scalar
                     multiplication (GLV / GLS), subgroup checks, cofactor
                     clearing, psi, to_affine
  pairing          — G2 preparation, Miller loop, final exponentiation;
                     Gt (gt.py)
  ops              — the NTT over Fr (ntt, intt, poly_mul) and the MSM
                     (msm_g1, msm_g1_large, msm_g2)
  convert          — arrays of the JAX package <-> the port's tensors
  entry            — `entry()`, `ntt_entry()`, `msm_entry()`, `smul_entry()`:
                     the paths and example inputs

A tensor on a CUDA device goes through the kernels; a CPU tensor through
their plain PyTorch versions.  Entry points default to `device="cuda"`.
"""

__version__ = "0.1.0"
