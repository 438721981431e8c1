"""BLS12-381 in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch and CUDA port of `bls12_381_tpu` (which stays in the repository
as the reference), slice by slice; the slices so far are the batched
optimal-ate pairing, the radix-2 NTT over the scalar field, the G1/G2
group law with Pippenger multi-scalar multiplication, the batched
scalar multiplications of G1, G2 and Gt with the subgroup checks and
cofactor clearing, the square roots, point codecs and hash to curve
that a BLS signer and verifier need, and the sharded MSM, NTT and pairing
across the ranks of a `torch.distributed` process group.  Same numeric domain and boundary
layout as the JAX
package: a field element batch is an int32 tensor [L, *batch] of 16-bit
Montgomery limbs (R = 2^384 for Fp, 2^256 for Fr), so values compare as
plain arrays.

Layers:
  params, hostmath — constants (with hash to curve's SSWU and isogeny
                     ones) and the host oracle on Python ints, name for
                     name the JAX package's (the host pairing gives Gt's
                     generator; its codecs, expanders, hash to curve,
                     multi-Miller loop, psi and Fr are the oracles)
  limbs            — batched 16-bit-limb Montgomery arithmetic
  kernels          — CUDA kernels (sop_rows as sop / fold_planned / sop_fr,
                     sqr, plan_exec, butterfly, pow_fixed, pow_fixed_fr,
                     fp2_pow_fixed; the device SHA-256 / XMD and SHAKE /
                     XOF expanders of sha256.py and keccak.py) and plain
                     versions
  fields           — Fp, the Fp2/Fp6/Fp12 tower, Fr; square roots and signs
  utils            — power-of-two scans and reductions, table lookups;
                     tracing: a torch.profiler scope and the program's
                     stage spans, read by portbench (profiling.py);
                     the native host runtime (native.py: Fp byte codecs
                     and expand_message_xmd in C++, built at first use)
  curves           — G1 and G2: the complete group law, scalar
                     multiplication (GLV / GLS), subgroup checks, cofactor
                     clearing, psi, to_affine, the byte codecs
  pairing          — G2 preparation, Miller loop, final exponentiation;
                     Gt (gt.py)
  ops              — the NTT over Fr (ntt, intt, poly_mul) and the MSM
                     (msm_g1, msm_g1_large, msm_g2)
  hash_to_curve    — hash_to_field, SSWU, the isogenies, hash_to_curve and
                     encode_to_curve for G1 and G2 (draft-16)
  parallel         — meshes of ranks (DeviceMesh), msm_g1/g2_sharded,
                     ntt_sharded (four-step), pairing_sharded
  convert          — arrays of the JAX package <-> the port's tensors
  entry            — `entry()`, `ntt_entry()`, `msm_entry()`, `smul_entry()`,
                     `codec_entry()`, `h2c_entry()`, `multichip_entry()`:
                     the paths and example inputs

A tensor on a CUDA device goes through the kernels; a CPU tensor through
their plain PyTorch versions.  Entry points default to `device="cuda"`.
"""

__version__ = "0.1.0"
