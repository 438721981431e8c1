#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (each prints its lines and seconds; any failed check exits non-zero):
  1. device: name, count, power limit (nvidia-smi), torch, the CUDA driver
     and toolkit versions (the row kernel's largest parameter block needs
     12.1 in both), nvcc.
  2. build: every kernel of `bls12_381_torch/kernels/csrc/` with nvcc for
     sm_90a (one process per source, in parallel), with ptxas registers,
     shared memory and spills (the plan, power and row kernels' also as
     JSON, the row kernel per field and parameter capacity).
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the paths' shapes, random canonical inputs plus the edge
     values 0, 1, p-1 (and q-2 and the butterfly's correction rows for
     Fr).  The row kernel (`sop_rows`, behind `sop`, `fold_planned` and
     `sop_fr`): T = 1, 2, 6, 8 products, uneven folds, repeated operands, a
     6-term group of p-1 rows, the operand layouts it reads in place (the
     pairing's line scaling as movedim views with yp, xp expanded over 68,
     a 0::2 scan level, a [24, n, 1] broadcast, a [24, 1] constant) and a
     non-affine one it copies; the calls of one pairing (its folds and its
     norm), one msm_g1 (its products), one ntt (its twiddle doublings) and
     one call of each smul row of phase 7 at its width (by route),
     recorded with their operands' strides and replayed; and, on the
     shapes that pick the launch shape, the chosen shape beside split = 1
     and a 32-lane tile.  Each launch prints its lane tile, group slots,
     threads per group, blocks, parameter bytes, registers and spills.
     Every plan at one lane, a ragged last tile and batch 1024, the
     group-law plans also at the MSM's widths and phase smul's 4096, each
     with its launch shape:
     lane tile, blocks, threads, shared memory, phases, registers;
     `pow_fixed` (csrc/mont_pow.cuh, 4, 2 or 1 threads per lane by the
     width: mont.pow_threads_per_lane) at p - 2, (p+1)/4, (p-1)/2, 1, 2
     and 16, and `pow_fixed_fr` (2 or 1) at q - 2 and (t-1)/2, B = 1, 33,
     1021, 1024, 8192 and 2^16 (the last two held on sampled lanes),
     over the edge lanes 0, 1, 2, m-1, m-2, R mod m, timed at p - 2 and
     q - 2 at B = 1, 1024 and 2^16, with its threads per lane, lanes per
     block, blocks, shared bytes, registers, spills and both bounds;
     `fp2_pow_fixed` (csrc/fp2_pow.cuh, two threads per lane) at (p-3)/4,
     (p-1)/2, 0, 1, 2 and B = 1, 33, 256, 512, 1021, 1024 and 2^16 (held on
     sampled lanes) over the Fp2 edge lanes (0, 0), (1, 0), (0, 1),
     (p-1, p-1), (0, p-1), (p-1, 0), (p-1, 1), (1, p-1), (R mod p, 0),
     timed at B = 1, 256, 512, 1024 and 2^16, with its lanes, threads per
     lane, blocks, shared bytes, registers, spills and both bounds; `sqr`
     (csrc/mont_sqr.cuh) at G = 1 and 3, B = 1, 33, 1024, 2^16 and 2^20
     (held on sampled lanes) over the edge lanes 0, 1, p-1, R mod p and
     R^2 mod p, timed at G = 1 and B = 1024, 2^16, 2^20 (and G = 3 at
     1024), with its threads, lanes per thread, blocks, parameter bytes,
     registers, spills and both bounds;
     exact equality (integers: tolerance none); CUDA events around
     back-to-back calls (the host's issue rate for short kernels) and the
     plain version's time (CUDA events; no yardstick).  The rows bound by
     bytes that this phase builds (sop, sqr, the folds, sop_fr, butterfly)
     are timed over copies of their operands taken in turn, more than
     twice the L2 in all, so that each launch reads from HBM.
  3b. hashes: the hash kernels (csrc/sha256.cu: expand_message_xmd and
     the digest; csrc/keccak.cu: the SHAKE sponge, behind shake and
     expand_message_xof) against their plain versions on the card and
     against hashlib / hostmath, byte for byte on every lane: XMD message
     lengths 0 to 200 (b0 over one, two and three blocks), outputs of 32
     to 8160 bytes (ell = 255; 33 and 36 store by bytes and words), DSTs
     of 1 to 300 bytes (300 reduced on the host), the messages of length
     a multiple of 4 also from rows 4 and 1 bytes past an aligned start
     (every message load instance of the XMD kernel runs); SHAKE
     messages of 0, r-1, r, r+1 and 2r bytes to 1, r, r+1 and 512 bytes
     at r = 136 and 168, the XOF at both levels; B = 1, 33, 256
     and 2^16; then timed at 256 and 2^16 lanes and at one lane (the
     chain), each beside its bounds by operations and by bytes and the
     plain version's time.
  4. main: the batched pairing at batch 1024 from the repository's test
     vectors ([a]G1, [b]G2, a, b < 1000): lane (1, 1) equals the RELIC
     value, lanes with equal a*b are equal, identity lanes are one, four
     lanes equal the plain path (CPU); launch counts of one pairing (every
     kernel of the path > 0; plan, sop, fold_planned and pow_fixed counts,
     and sqr = 0 and copied_rows = 0, equal to the static schedule); stage
     times and pairings/s on a host clock around synchronized work (median
     of STAGE_REPS runs), and the share of that wall time the host thread
     spent on the CPU issuing the work.
  5. ntt: the radix-2 NTT over Fr at N = 2^20 (`entry.ntt_entry`): launch
     counts of one ntt and one intt equal the static schedule;
     intt(ntt(x)) = x; eight outputs equal the host's evaluation at
     omega^k; a 2^12 NTT on the card equals the CPU path; poly_mul of two
     2^19-coefficient polynomials satisfies c(r) = a(r) b(r) at four
     points; ntt / intt / poly_mul seconds as in phase 4, and the NTT's
     own peak memory.
  6. msm: `msm_g1` at 2^16 points (GLV) and `msm_g2` at 2^12 (GLS), window
     12, from `entry.msm_entry` (P_i = [i+1]G with identity lanes, random
     scalars with zeros): launch counts equal the static schedule
     (fold_planned > 0 in msm_g2); the affine result equals the host's
     [sum_i k_i (i+1) mod q]G; at 2^10 points the card equals the CPU path
     in projective coordinates and glv=False / gls=False agree; host-clock
     median of MSM_REPS runs after the warm-up, host CPU share, the MSM's
     own peak memory.
  6b. msm_large: bench.py:553-599's G1 rows, msm_g1_large at window 13
     through `entry.msm_entry` (2^21-point chunks folded by single adds)
     on 2^20 and 2^24 points (the north star): the inputs' scan seconds
     and peak; launch counts equal `expected_msm_large_launches`; the
     affine result equals the host's [sum_i k_i (i+1) mod q]G, summed by
     numpy dot products over the Montgomery limbs (`msm_host_sum`); 2^24
     also at chunks of 2^22 and 2^23 points (the same point, each call's
     own peak), and msm_g1_large = one msm_g1 pipeline at 2^22; 2^20 at
     window 12 too; host-clock medians of 5 (2^20) and 3 (2^24), points/s,
     host CPU share; the 2^24 tensors are freed after it.  Phase kernels
     holds g1_add at 2^21 and 2^22 lanes and a product at 2^21, the
     chunk's widest launches, against the plain versions on sampled
     lanes.
  7. smul: bench.py:350-427's rows through the port's entry points:
     g1.scalar_mul (GLV) at 2^10 and 2^12 lanes, g2.scalar_mul (GLS) and
     gt.scalar_mul (GLS) at 2^10, g1/g2.is_torsion_free and
     clear_cofactor at 2^12 (the scalar multiplications' outputs, every
     64th lane a point outside the subgroup), g1/g2.batch_normalize at
     10,000 points: launch counts equal the static schedule, the row's
     checks (the split equals scalar_mul_generic on every lane, 8 lanes
     equal the host oracle, the torsion checks exactly false outside the
     subgroup, cleared points torsion-free and equal to the host's
     [h_eff]P), 16 lanes on the card equal the CPU path, host-clock median
     of SMUL_REPS runs after the counted warm-up, own peak memory.
  8. codec: bench.py:429-462's decoders at 2^10 through
     `entry.codec_entry` (G1/G2 compressed and uncompressed, checks on;
     lanes i % 64 == 17 a point outside the subgroup) and the four
     encoders on their output: launch counts equal
     `expected_codec_launches`, the masks false exactly there (true with
     the check off), 8 lanes equal the host oracle, 16 lanes on the card
     equal the CPU path, every encoding equals hostmath's; the four
     1000-point tests/vectors/*.dat walks decode and re-encode byte for
     byte; every flag-bit reject is invalid; host-clock median of
     CODEC_REPS runs, own peak memory.
  9. h2c: bench.py:465-490's rows at 256 through `entry.h2c_entry`
     (hash_to_curve and encode_to_curve of G1 and G2, device expansion):
     the device XMD equals hashlib's on every lane (and is timed alone in
     turns with each row, beside its plain version on the card),
     the 20 draft-16 KATs, launch counts equal `expected_h2c_launches`,
     torsion-free outputs, 16 lanes on the card equal the CPU path,
     host-clock medians, the host expander beside hash_to_curve_g2.
  10. bls: the proof-of-possession round trip at 256 lanes (keygen, sign,
     serialize, parse with the subgroup checks, verify by pairing): every
     honest lane verifies, every tampered lane (another message, a flipped
     bit, a point outside G2) fails; launch counts equal
     `expected_bls_launches`; each stage's seconds.
  11. oracle: the card's paths against the independent host code (in
     spawned processes while the card works): hash_to_curve and
     encode_to_curve of phase h2c's messages (G1 on all 256 lanes, G2 on
     16) against hostmath's, the 8-term multi-pairing (with a G1 and a G2
     identity) against the host's final_exponentiation(multi_miller_loop),
     g2.psi on 256 points against g2_psi, fr.sqrt (roots and mask) and
     fr.inv on 2^10 lanes, the Fr byte codecs with their rejects; the
     native host runtime (utils/native.py): its Fp codec at 2^16 rows
     against fp.from_bytes_host on the card, its XMD at 256 lanes against
     hostmath's and the device XMD; launch counts equal
     `expected_oracle_launches`; host-clock medians of the three XMDs and
     of the native decoder beside a hostmath loop.
  12. parallel: the sharded paths of `bls12_381_torch/parallel/` at the
     widths above (pairing_sharded at batch 1024 on phase 4's inputs,
     element-wise and aggregated with and without the final
     exponentiation; msm_g1_sharded at 2^16 and msm_g2_sharded at 2^12,
     window 12; ntt_sharded at 2^20 and its inverse), on one NCCL rank in
     this process and on four gloo ranks spawned on the one card (msm_g1
     and the NTTs also on a 2 x 2 mesh), then `entry.multichip_entry` on
     every rank: every rank's values equal the local paths' (pairing,
     multi_miller_loop, its final exponentiation = the host's
     e(G1, G2)^(sum a_i b_i), the MSMs in affine = the host's point, ntt /
     intt limb for limb), launch counts equal
     `expected_parallel_launches`, own peak memory < 1 GB; at 4 ranks
     `shard_batch`'s lanes on the 2 x 2 mesh for each axis_name equal
     `expected_shards`; host-clock medians of 5 runs per row at 1 and 4
     ranks beside the local call's.
  13. kernel times: each kernel's device time per launch at the shapes of
     phase 3 (torch.profiler); after phases 4-12, because a profiler
     session may slow the host's launches for the rest of the process.
  14. fold routes: the operands read in place (`limbs.sop_fold`,
     `limbs.sum_of_products`) against the route before the row kernel
     (operands stacked into one tensor, then the same kernel) on the same
     operands: the paths' folds of two and three groups, the line scaling
     in its own layout, T = 7, 8, the pairing's norm and an MSM scan level;
     equal values, device ms of all device work and issue ms per call.
  15. profiles: one pairing, one NTT, one msm_g1, one msm_g2, one
     msm_g1_large at 2^20 and one call of each smul, codec and h2c row
     under torch.profiler -- device time by kernel (device-side events
     only), the port kernels' ms per launch, the `CatArrayBatchedCopy` and
     other copy launches, the rows `sop_rows` copied, and the device's busy
     share: the union of kernel intervals over the unprofiled wall time.
  16. the `kernels` JSON line (each kernel's launches per path, the smul,
     codec and h2c rows', the round trip's, phase msm_large's (2^20 and
     2^24), phase oracle's and phase parallel's as `launches_<row>`, the
     last two as `launches_oracle_<check>` and
     `launches_parallel_<row>_r<ranks>`: rank 0's; the hash kernels' rows
     also at 2^16 lanes, with one lane's device time as `chain_ms`), then
     the device JSON line last.

The script imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VECTORS = ROOT / "tests" / "vectors"
BATCH = 1024
NTT_LOG_N = 20                     # bench.py's scalar NTT 2^20
NTT_N = 1 << NTT_LOG_N
SEED = 20261016
DOUBLINGS = f"sop_fr twiddle doublings of one ntt at 2^{NTT_LOG_N}"
PAIRING_FOLDS = f"fold_planned folds of one pairing, batch {BATCH}"
PAIRING_NORM = f"sop norm of one pairing, batch {BATCH}"
STAGE_REPS = 7                     # host-clock runs per stage; median kept
MSM_LOG_N = {"g1": 16, "g2": 12}   # a 2^16 KZG commitment; 4096 signatures
MSM_CHECK_LOG_N = 10               # the card = CPU comparison
MSM_REPS = 5
PLAN_RAGGED = 1021                 # 255 tiles of 4 lanes and one of 1
# phase msm_large: bench.py:553-599's G1 rows through msm_g1_large, window
# 13, at 2^20 and 2^24 points (BASELINE.md's north star); 2^24 also at
# chunks of 2^22 and 2^23 points beside the default 2^21, and msm_g1_large
# against one msm_g1 pipeline at 2^22
MSM_LARGE_C = 13
MSM_LARGE_LOG_NS = (20, 24)
MSM_LARGE_CHUNKS = (21, 22, 23)
MSM_LARGE_EQ_LOG_N = 22
MSM_LARGE_REPS = {20: 5, 24: 3}
MSM_LARGE_OTHER_C = 12             # the 2^20 row again at another window
MSM_HOST_BLOCK = 1 << 20           # lanes per numpy dot of the host oracle
# the widest launches of one default chunk (2^21 points, 2^22 GLV lanes):
# the scans' g1_add at 2^21 lanes (2^22 at chunk 22), to_affine's products
# at 2^21; the plain versions compare on sampled lanes
MSM_LARGE_PLAN_WIDTHS = (1 << 21, 1 << 22)
MSM_LARGE_SOP_WIDTH = 1 << 21
SAMPLED_LANES = 1024               # per sample: first, last, random lanes
MSM_SOPS = f"sop products of one msm_g1 at 2^{MSM_LOG_N['g1']}"
# bench.py:350-427's scalar multiplication, subgroup and normalization rows:
# (group, function, lanes)
SMUL_ROWS = (("g1", "scalar_mul", 1 << 10), ("g1", "scalar_mul", 1 << 12),
             ("g2", "scalar_mul", 1 << 10),
             ("g1", "is_torsion_free", 1 << 12),
             ("g2", "is_torsion_free", 1 << 12),
             ("g1", "clear_cofactor", 1 << 12),
             ("g2", "clear_cofactor", 1 << 12),
             ("gt", "scalar_mul", 1 << 10),
             ("g1", "batch_normalize", 10000),
             ("g2", "batch_normalize", 10000))
SMUL_REPS = 5
SMUL_CPU_LANES = 16                # the card = CPU comparison
BAD_LANE = 17                      # lanes i % 64 == 17: a point outside G1 / G2
# the Fp2 square root's exponents (p-3)/4 and (p-1)/2 (tower.fp2_sqrt)
# beside 0, 1 and 2
FP2_POW_EXPONENTS = ("(p-3)/4", "(p-1)/2", "0", "1", "2")
FP2_POW_TIMED = ("(p-3)/4", "(p-1)/2")
# phase codec's 2^10 lanes, a partial block, h2c's 2 x 256 and 256 lanes
# (the round trip's too), a pair of warps of which one lane is live, one
# lane; and the card full, held on sampled lanes
FP2_POW_WIDTHS = (1024, 1021, 512, 256, 33, 1)
FP2_POW_WIDE = 1 << 16
FP2_POW_TIMED_WIDTHS = (1, 256, 512, 1024, FP2_POW_WIDE)
FP2_POW_LANE_BYTES = 16 * 2 * 12 * 4  # window table per lane (fp2_pow.cuh)
# pow_fixed / pow_fixed_fr (mont_pow.cuh): the inversions' and square
# roots' exponents (Fr's (t-1)/2: fr.sqrt) beside 1, 2 and 16; one lane, a
# partial block, a partial last warp, the paths' 1024; the widths where the
# launch takes 2 (Fp) and 1 threads a lane, held on sampled lanes; the
# inversions timed at 1, 1024 and 2^16
POW_EXPONENTS = {"pow_fixed": ("p-2", "(p+1)/4", "(p-1)/2", "1", "2", "16"),
                 "pow_fixed_fr": ("q-2", "(t-1)/2")}
POW_TIMED = ("p-2", "q-2")
POW_WIDTHS = (1024, 1021, 33, 1)
POW_WIDE = 1 << 16
POW_SAMPLED = (1 << 13, POW_WIDE)  # slices of the POW_WIDE operand
POW_TIMED_WIDTHS = (1, 1024, POW_WIDE)
FP2_EDGE_LANES = ("0", "0"), ("1", "0"), ("0", "1"), ("p-1", "p-1"), \
    ("0", "p-1"), ("p-1", "0"), ("p-1", "1"), ("1", "p-1"), ("R", "0")
# sqr (mont_sqr.cuh): one lane, a partial block, the decompression's and
# h2c's widths, the card full and 2^20 (held on sampled lanes); timed at
# G = 1 from HBM; 24 bytes of parameters (two pointers, G, B)
SQR_WIDTHS = (1, 33, 1024, 1 << 16, 1 << 20)
SQR_TIMED_WIDTHS = (1024, 1 << 16, 1 << 20)
SQR_PARAM_BYTES = 24
CODEC_LOG_N = 10                   # bench.py:429-462's decoding rows at 2^10
CODEC_FORMS = ("compressed", "uncompressed")
CODEC_REPS = 5
CODEC_CPU_LANES = 16               # the card = CPU comparison
H2C_LOG_N = 8                      # bench.py:465-490's rows at batch 256
H2C_ROWS = (("g1", "hash"), ("g2", "hash"), ("g1", "encode"),
            ("g2", "encode"))
H2C_REPS = 5
H2C_CPU_LANES = 16
# draft-16's test DSTs of the hash-to-curve KATs in tests/vectors/h2c_kats.json
KAT_DSTS = {
    "g1_ro": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_RO_",
    "g1_nu": b"QUUX-V01-CS02-with-BLS12381G1_XMD:SHA-256_SSWU_NU_",
    "g2_ro": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_",
    "g2_nu": b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_NU_",
}
BLS_LOG_N = 8                      # the round trip's lanes
# the proof-of-possession suite, minimal public-key size (pk in G1)
BLS_DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
BLS_WRONG_MESSAGE, BLS_FLIPPED_BIT, BLS_OUTSIDE_G2 = 3, 7, 11  # lanes i % 64
ORACLE_WORKERS = 8                 # spawned processes for the host oracle
ORACLE_G2_LANES = 16               # host hash_to_curve_g2: ~0.5 s a lane
ORACLE_TERMS = 8                   # the multi-pairing's terms
ORACLE_PSI_LOG_N = 8
ORACLE_FR_LOG_N = 10
ORACLE_CODEC_LOG_N = 16            # the native Fp codec's rows
ORACLE_XMD_LENGTHS = (128, 256)    # hash_to_curve's G1 and G2 OKM lengths
ORACLE_REPS = 5
# phase parallel: the sharded paths at the widths above on one rank (NCCL,
# in this process) and on PARALLEL_RANKS ranks sharing the card (gloo,
# spawned: NCCL refuses two ranks of one communicator on one device)
PARALLEL_RANKS = 4
PARALLEL_WINDOW = 12
PARALLEL_REPS = 5
# shard_batch's axis_name choices on the 2 x 2 mesh, and the keys of
# parallel_job's result that are not rows
SHARD_AXES = (None, "host", "x", ("host", "x"), ("x", "host"))
NOT_ROWS = ("entry", "shards")
PEAK_LIMIT_BYTES = 1 << 30         # PERF.md section 2: < 1 GB per row


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + json.dumps(kv, default=str), flush=True)


# ---------------------------------------------------------------------------
# Work and bounds per kernel call (per lane; see kernels/mont.py)
# ---------------------------------------------------------------------------


def sop_imads(T: int, words: int = 12) -> int:
    """32-bit multiplies of a T-term sum of products over `words` 32-bit
    words (12 for Fp, 8 for Fr): T word products and the reduction's
    words^2 + words, a wide product counting lo and hi."""
    return 2 * words * words * (T + 1) + words


def sqr_imads(words: int = 12) -> int:
    """32-bit multiplies of a square (montgomery.cuh's sqr_wide and
    mont_sqr.cuh's sqr_words alike): the words (words - 1) / 2
    off-diagonal and `words` diagonal word products, then the reduction."""
    return 2 * (words * (words + 1) // 2 + words * words) + words


BUTTERFLY_IMADS = sop_imads(1, 8)  # one Fr product; the add/sub are IADDs
BUTTERFLY_BYTES = 4 * 16 * 5       # a, b, w read; lo, hi written (int32)

# 32-bit instructions the hash kernels need at least, counted from
# csrc/sha256.cu and csrc/keccak.cu as sm_90 issues them: one LOP3 for any
# boolean function of up to three inputs, one IADD3 for an add of up to
# three, one funnel shift (SHF) for a 32-bit rotation or shift and two for
# a 64-bit rotation.  A SHA-256 compression: 48 schedule words (each sigma
# two rotations, a shift and a LOP3; the four-term add two IADD3) and 64
# rounds (S1 and S0 three rotations and a LOP3 each; ch and maj a LOP3
# each; t1's five terms two IADD3, e one add, a one IADD3), then eight
# adds.  A Keccak-f[1600] permutation: 24 rounds of 180 on the two 32-bit
# halves of each lane (theta: the five-way column xors 2 x 2 x 5, the
# rotations of D 2 x 5, a ^= C[x-1] ^ rot(C[x+1]) one LOP3 a half, 50;
# rho 24 rotations, 48; chi one LOP3 a half, 50; iota 2).
SHA256_COMPRESSION_OPS = (48 * (4 + 4 + 2) + 64 * (4 + 1 + 2 + 4 + 1 + 1 + 1)
                          + 8)
KECCAK_F_OPS = 24 * (20 + 10 + 50 + 48 + 50 + 2)


def sha256_blocks(n_bytes: int) -> int:
    """Compressions of the SHA-256 of n_bytes (the padding adds 9 bytes
    at least)."""
    return -(-(n_bytes + 9) // 64)


def xmd_work(B: int, msg_len: int, len_in_bytes: int, dst_len: int):
    """(bytes, 32-bit operations) of one expand_message_xmd launch over B
    lanes: each message read once and each output written once; b0's
    blocks after the Z_pad midstate (the host's, once per call) and ell
    b_i of (b0 ^ b_(i-1)) || i || DST' each."""
    dst_prime = (32 if dst_len > 255 else dst_len) + 1
    ell = -(-len_in_bytes // 32)
    blocks = (sha256_blocks(64 + msg_len + 3 + dst_prime) - 1
              + ell * sha256_blocks(33 + dst_prime))
    return (B * (msg_len + len_in_bytes),
            B * blocks * SHA256_COMPRESSION_OPS)


def shake_work(B: int, n_absorbed: int, msg_len: int, out_len: int,
               rate: int):
    """(bytes, 32-bit operations) of one SHAKE launch over B lanes whose
    sponge absorbs n_absorbed bytes a lane (the message and any suffix)
    and squeezes out_len: the permutations after each absorbed block and
    between squeezed ones."""
    perms = n_absorbed // rate + 1 + (-(-out_len // rate) - 1)
    return B * (msg_len + out_len), B * perms * KECCAK_F_OPS


def pow_chain(exponent: int, modulus: int):
    """(squares, products) one lane of the power kernel runs for this
    exponent: the window table's 14 products, then after the leading
    nonzero digit 4 squares per digit and a product per nonzero digit."""
    from bls12_381_torch.kernels import mont

    digits = [int(d) for d in mont.pow_digits(exponent, modulus)]
    rest = digits[next((i for i, d in enumerate(digits) if d), len(digits)):]
    rest = rest[1:]
    return 4 * len(rest), 14 + sum(1 for d in rest if d)


def pow_work(spec, exponent: int, B: int):
    """(bytes, 32-bit multiplies) of one power launch over B lanes: the
    operand read and the result written once (int32 limbs); squares by
    the sqr kernel's body."""
    words = spec.n_limbs // 2
    squares, products = pow_chain(exponent, spec.modulus)
    return (4 * spec.n_limbs * 2 * B,
            B * (squares * sqr_imads(words)
                 + products * sop_imads(1, words)))


def fp2_pow_work(exponent: int, B: int):
    """(bytes, 32-bit multiplies) of one Fp2 power launch over B lanes: a0,
    a1 read and c0, c1 written once (int32 limbs); pow_chain's schedule of
    Fp2 squares, each two one-term Fp products (sop_imads(1)), and Fp2
    products at their least work, Karatsuba's three word products with two
    reductions (the kernel does four): 3 x 2 W^2 + 2 (2 W^2 + W)."""
    from bls12_381_torch import params

    W = 12
    squares, products = pow_chain(exponent, params.P)
    fp2_product = 3 * 2 * W * W + 2 * (2 * W * W + W)
    return (4 * 24 * 4 * B,
            B * (2 * squares * sop_imads(1) + products * fp2_product))


def bound(n_bytes: float, n_imads: float):
    """(least ms, what bounds it) on one H100 (`utils/profiling.py`'s
    HBM_BYTES_PER_S and IMAD_PER_S)."""
    from bls12_381_torch.utils.profiling import HBM_BYTES_PER_S, IMAD_PER_S

    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_imads / IMAD_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------

L2_BYTES = 50 << 20                # the H100's L2


def rotating(fn, *operands):
    """(call, copies): a call of fn that takes the next of `copies` copies
    of its operands each time, enough copies that they hold more than twice
    the card's L2.  Launched back to back, each call then reads operands
    the L2 no longer holds, from HBM, as a path's call on fresh data does;
    over one set of operands a kernel whose operands fit in the L2 would
    read them from there and time under its bound by bytes."""
    size = sum(t.untyped_storage().nbytes() for t in operands)
    copies = -(-(2 * L2_BYTES + 1) // size)
    sets = [operands] + [tuple(t.clone() for t in operands)
                         for _ in range(copies - 1)]
    turn = itertools.cycle(sets)
    return (lambda: fn(*next(turn))), copies


def time_events(fn, n: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_events(fn):
    """Run fn once under torch.profiler and return its device-side events
    (kernels, copies) as (name, start_us, end_us).  Only device activity
    is traced: tracing the host's torch ops too gives the same device events
    and takes several times as long on the h2c rows' tens of thousands of
    ops."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # a marker kernel first, finished before fn starts: profiles of the
        # smul rows lost the first kernel of fn (their Fr conversion), and
        # the marker's own event is dropped below
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    evs = [(ev.name, ev.time_range.start, ev.time_range.end)
           for ev in prof.events() if ev.device_type == DeviceType.CUDA
           and "spin_kernel" not in ev.name]
    # the profiler's records are cyclic garbage; collect them now, or a
    # full collection of them lands inside a later host-clock timing
    del prof
    gc.collect()
    return evs


def busy_us(evs) -> float:
    """Length of the union of the events' device intervals, in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((start, end) for _, start, end in evs):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def host_times(fn, reps: int = STAGE_REPS):
    """`reps` runs of fn: the wall seconds of each, ending in a
    synchronize, and the host thread's CPU seconds spent issuing it (the
    thread clock may tick coarsely: compare sums, not single runs)."""
    import torch

    wall, cpu = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.thread_time()
        fn()
        cpu.append(time.thread_time() - c0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    return wall, cpu


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    from bls12_381_torch.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    toolkit = re.search(r"release (\d+)\.(\d+)", nvcc.stdout)
    toolkit = (int(toolkit[1]), int(toolkit[2])) if toolkit else None
    # the driver's CUDA version, from the driver library itself
    version = ctypes.c_int(0)
    ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(ctypes.byref(version))
    driver = (version.value // 1000, version.value % 1000 // 10)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        nvcc=nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else None,
        driver_cuda=driver, toolkit_cuda=toolkit,
        # the row kernel's largest capacity (27 KB of parameters) needs 12.1
        # in both
        params_over_4kb=bool(toolkit and min(driver, toolkit) >= (12, 1)),
        python=sys.version.split()[0])
    print(smi_line, flush=True)
    return smi_line


def phase_build():
    from bls12_381_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    say("build", seconds_total=time.perf_counter() - t0, seconds=secs,
        flags=" ".join(build.NVCC_FLAGS))
    for stem in build.SOURCES:
        for line in build.ptxas_report(stem):
            print(f"[build:{stem}] {line}", flush=True)
    usage = {"plan_exec": ptxas_usage("plan_exec", "plan_kernel"),
             # the power's instances by threads per lane (the launch
             # picks one by the width: mont.pow_threads_per_lane)
             **{f"pow_fixed t{t}": ptxas_usage(
                 "mont", "15mont_pow_kernel", f"ELi{t}ELi32E")
                for t in (4, 2, 1)},
             **{f"pow_fixed_fr t{t}": ptxas_usage(
                 "fr", "15mont_pow_kernel", f"ELi{t}ELi32E")
                for t in (2, 1)},
             "fp2_pow_fixed": ptxas_usage("mont", "fp2_pow_kernel"),
             "sqr": ptxas_usage("mont", "7montsqr10sqr_kernel"),
             # the XMD's instances by message load width; the main path's
             # 32-byte rows take 16
             "xmd_sha256": ptxas_usage("sha256", "17xmd_sha256_kernelILi16E"),
             "xmd_sha256 load4": ptxas_usage("sha256",
                                             "17xmd_sha256_kernelILi4E"),
             "xmd_sha256 load1": ptxas_usage("sha256",
                                             "17xmd_sha256_kernelILi1E"),
             "sha256": ptxas_usage("sha256", "13sha256_kernel"),
             "shake": ptxas_usage("keccak", "12shake_kernel")}
    for suffix, stem in (("", "mont"), ("_fr", "fr")):
        for r, e in ROW_CAPS:
            usage[f"sop_rows{suffix} {r}x{e}"] = ptxas_usage(
                stem, "sop_rows_kernel", f"SopRowsArgsILi{r}ELi{e}E")
    say("build", registers_and_spill_bytes=usage)
    return usage


def ptxas_usage(stem: str, *parts: str):
    """(registers, spill store + load bytes) of the kernel whose mangled
    name holds every one of `parts`, from `ptxas -v`'s lines in its
    library's build log."""
    from bls12_381_torch.kernels import build

    regs = spills = None
    mine = False
    for line in build.ptxas_report(stem):
        if "Compiling entry" in line:
            mine = all(part in line for part in parts)
        elif mine and (m := re.search(r"Used (\d+) registers", line)):
            regs = int(m[1])
        elif mine and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills = int(m[1]) + int(m[2])
    return regs, spills


def rand_fp(shape, gen, device):
    """Random canonical Fp limbs [24, *shape] (top limb < p's top limb)."""
    import torch

    from bls12_381_torch import limbs

    x = torch.randint(0, 1 << 16, (24,) + tuple(shape), generator=gen,
                      device=device, dtype=torch.int32)
    x[23] = torch.randint(0, limbs.FP.p_limbs[23], tuple(shape),
                          generator=gen, device=device, dtype=torch.int32)
    return x


def rand_fr(shape, gen, device):
    """Random canonical Fr limbs [16, *shape]: the top limb masked to 14
    bits, values < 2^254 < q (the NTT inputs' distribution)."""
    import torch

    x = torch.randint(0, 1 << 16, (16,) + tuple(shape), generator=gen,
                      device=device, dtype=torch.int32)
    x[15] &= 0x3FFF
    return x


def edge_col(value: int, device, n_limbs: int = 24):
    import torch

    from bls12_381_torch import params

    return torch.tensor(params.to_limbs(value, n_limbs), dtype=torch.int32,
                        device=device)


def pow_operand(spec, B: int, gen, device):
    """Random canonical limbs [L, B] of the field; lanes 1..6 hold 0, 1, 2,
    m-1, m-2 and R mod m, as many as B has room for."""
    m, L = spec.modulus, spec.n_limbs
    x = (rand_fp if L == 24 else rand_fr)((B,), gen, device)
    edges = (0, 1, 2, m - 1, m - 2, (1 << (16 * L)) % m)
    for lane, v in enumerate(edges[:max(B - 1, 0)]):
        x[:, lane + 1] = edge_col(v, device, L)
    return x


def fp2_exponent(label: str) -> int:
    from bls12_381_torch.params import P

    return {"(p-3)/4": (P - 3) // 4, "(p-1)/2": (P - 1) // 2, "0": 0, "1": 1,
            "2": 2}[label]


def fp2_pow_operand(B: int, gen, device):
    """Random canonical (a0, a1) [24, B]; lanes 0..8 hold FP2_EDGE_LANES
    (0 as 0, 1 as 1, p-1 as p - 1, R as R mod p), as many as B holds."""
    from bls12_381_torch.params import P

    value = {"0": 0, "1": 1, "p-1": P - 1, "R": (1 << 384) % P}
    a0, a1 = rand_fp((B,), gen, device), rand_fp((B,), gen, device)
    for lane, (x, y) in enumerate(FP2_EDGE_LANES[:B]):
        a0[:, lane] = edge_col(value[x], device)
        a1[:, lane] = edge_col(value[y], device)
    return a0, a1


def plan_edge_lanes(ops, P: int) -> None:
    """Lanes 0..3 of a plan's operands [K, 24, B], as many as B holds: every
    row p-1, every row 0, rows cycling 0, 1, p-1, every row 1."""
    rows = ops.shape[0]
    cols = {v: edge_col(v, ops.device) for v in (0, 1, P - 1)}
    lanes = ([P - 1] * rows, [0] * rows,
             [(0, 1, P - 1)[k % 3] for k in range(rows)], [1] * rows)
    for lane, values in enumerate(lanes[:ops.shape[2]]):
        for k, v in enumerate(values):
            ops[k, :, lane] = cols[v]


def compare(got, ref):
    import torch

    diff = (got.long() - ref.long()).abs()
    lanes = diff.reshape(-1, diff.shape[-1]).amax(0) if diff.dim() > 1 \
        else diff
    return int((lanes != 0).sum()), int(diff.max()) if diff.numel() else 0


# The port's kernels as the profiler names them on the card: the substrings
# each name holds.  One row-kernel template serves both fields: its Fp
# launches are the `sop` and `fold_planned` counts, its Fr ones `sop_fr`.
KERNEL_NAMES = {"sop_rows": ("sop_rows_kernel", "fp384"),
                "sqr": ("sqr_kernel",),
                "plan_exec": ("plan_kernel",),
                "sop_rows_fr": ("sop_rows_kernel", "fr256"),
                "butterfly": ("butterfly_kernel",),
                "pow_fixed": ("mont_pow_kernel", "fp384"),
                "pow_fixed_fr": ("mont_pow_kernel", "fr256"),
                "fp2_pow_fixed": ("fp2_pow_kernel",),
                "xmd_sha256": ("xmd_sha256_kernel",),
                "sha256": ("::sha256_kernel",),
                "shake": ("shake_kernel",)}
ROW_CAPS = ((16, 16), (64, 128), (1024, 512))  # montgomery.cuh SOP_ROWS_CAPS


def kernel_of(name: str):
    """The port kernel a device-side event belongs to, or None."""
    return next((k for k, subs in KERNEL_NAMES.items()
                 if all(sub in name for sub in subs)), None)


def profiled_launches(counts: dict) -> collections.Counter:
    """The device events a run's LAUNCHES counts must show, by
    KERNEL_NAMES key (the Fp sum-of-products kernel counts as `sop` for one
    group and as `fold_planned` for more)."""
    return +collections.Counter({
        "sop_rows": counts["sop"] + counts["fold_planned"],
        "sop_rows_fr": counts["sop_fr"], "sqr": counts["sqr"],
        "plan_exec": counts["plan_exec"], "butterfly": counts["butterfly"],
        "pow_fixed": counts["pow_fixed"],
        "pow_fixed_fr": counts["pow_fixed_fr"],
        "fp2_pow_fixed": counts["fp2_pow_fixed"],
        "xmd_sha256": counts["xmd_sha256"], "sha256": counts["sha256"],
        "shake": counts["shake"]})


FOLD_CASES = (
    (4, 1, 68 * BATCH, [[(1, 5)], [(2, 5)], [(3, 6)], [(4, 6)]]),
    (8, 2, 1 << 16, [[(1, 3), (2, 4)], [(1, 4), (2, 3)], [(5, 7), (6, 8)],
                     [(5, 8), (6, 7)], [(1, 7), (2, 8)], [(1, 8), (2, 7)],
                     [(5, 3), (6, 4)], [(5, 4), (6, 3)]]),
    (4, 6, 1 << 16, [[(9, 9)] * 6, [(1, 2)], [(3, 4), (4, 3), (1, 1)],
                     [(2, 5), (6, 7), (8, 1), (3, 3), (4, 4)]]),
)


def fold_bytes(B: int, groups) -> int:
    """Bytes a planned fold must move: each stack row that a term names
    read once (padding terms name the zero row and read nothing), each of
    the G outputs written once."""
    rows = {i for g in groups for pair in g for i in pair}
    return 4 * B * 24 * (len(rows) + len(groups))


def distinct_elements(x) -> int:
    """Elements of a tensor's own data: an axis of stride 0 (a broadcast)
    counts once."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        n *= size if stride else 1
    return n


def rows_work(call):
    """(bytes, 32-bit multiplies) a `sop_rows` call must do: each row its
    terms name read once, as the row's own elements, each of the G outputs
    written once; a T-term group's products and one reduction per lane."""
    spec, rows, ia, ib, counts, batch = call
    B = 1
    for d in batch:
        B *= d
    named = {int(t[g, i]) for t in (ia, ib) for g, n in enumerate(counts)
             for i in range(int(n))}
    words = spec.n_limbs // 2
    return (4 * (sum(distinct_elements(rows[k]) for k in named)
                 + len(counts) * spec.n_limbs * B),
            B * sum(sop_imads(int(n), words) for n in counts))


def rows_launch(call, n_sm: int, usage, shape=None) -> dict:
    """The launch of one `sop_rows` call: lane tile, group slots per
    block, threads per group, blocks, threads per block, parameter bytes
    (the kernel's own sizeof) and the capacity's registers and spills."""
    from bls12_381_torch.kernels import mont

    spec, rows, ia, ib, counts, batch = call
    G, T = ia.shape
    B = 1
    for d in batch:
        B *= d
    lt, gpb, split = shape or mont.sop_launch_shape(G, T, B, n_sm)
    r, e = next(c for c in ROW_CAPS if len(rows) <= c[0] and G * T <= c[1])
    regs, spills = usage[f"sop_rows{'_fr' if spec.n_limbs == 16 else ''} "
                         f"{r}x{e}"]
    return {"lane_tile": lt, "group_slots": gpb, "threads_per_group": split,
            "blocks": -(-B // lt), "threads": lt * gpb * split,
            "param_bytes": mont.sop_rows_param_bytes(len(rows), G * T),
            "registers": regs, "spill_bytes": spills}


def record_rows(fn):
    """Run fn once and return the calls it makes of `mont.sop_rows`:
    (spec, rows, ia, ib, counts, batch), each row a copy of its storage
    seen through the row's own size, strides and offset, so that a replay
    reads the layouts the path gave the kernel."""
    import numpy as np
    import torch

    from bls12_381_torch.kernels import mont

    calls, real = [], mont.sop_rows

    def spy(spec, rows, ia, ib, counts, batch, shape=None):
        copies = {}  # storages of this call's rows, each copied once

        def keep(x):
            st = x.untyped_storage()
            c = copies.get(st.data_ptr())
            if c is None:
                c = copies[st.data_ptr()] = st.clone()
            return torch.empty(0, dtype=x.dtype, device=x.device).set_(
                c, x.storage_offset(), x.size(), x.stride())

        calls.append((spec, [keep(x) for x in rows], np.array(ia),
                      np.array(ib), np.array(counts), tuple(batch)))
        return real(spec, rows, ia, ib, counts, batch, shape)

    mont.sop_rows = spy
    try:
        fn()
    finally:
        mont.sop_rows = real
    return calls


def fold_tables(groups):
    """[G, T] int32 index tables of groups of (ia, ib) pairs, short groups
    padded with row 0."""
    import numpy as np

    t = max(len(g) for g in groups)
    ia = np.zeros((len(groups), t), np.int32)
    ib = np.zeros((len(groups), t), np.int32)
    for gi, g in enumerate(groups):
        for ti, (a, b) in enumerate(g):
            ia[gi, ti], ib[gi, ti] = a, b
    return ia, ib


def msm_plan_shapes():
    from bls12_381_torch.kernels import plan_exec as pe

    n1, n2 = (1 << MSM_LOG_N[g] for g in ("g1", "g2"))
    return ((pe.g1_add_plan, n1), (pe.g1_double_plan, 1),
            (pe.g2_add_plan, 2 * n2), (pe.g2_double_plan, 1),
            (pe.g1_add_mixed_plan, BATCH), (pe.g2_add_mixed_plan, BATCH))


SMUL_PLAN_WIDTH = 1 << 12  # the widest group-law launches of phase smul
# phase hashes (PERF.md section 6): the expanders' widths, XMD message
# lengths that put b0 across one, two and three blocks, output lengths to
# ell = 255, DSTs to one over 255 bytes (reduced on the host)
HASH_WIDTHS = (1, 33, 256, 1 << 16)
HASH_TIMED_WIDTHS = (256, 1 << 16)  # hash to curve's rows; the card full
HASH_DST = b"BENCH-DST_"            # entry.H2C_DST
XMD_MSG_LENS = (0, 1, 32, 55, 56, 63, 64, 119, 120, 200)
XMD_OUT_LENS = (32, 33, 36, 48, 64, 128, 256, 8160)  # 33, 36: stores of 1, 4
XMD_DST_LENS = (1, 10, 43, 255, 300)
SHAKE_RATES = (136, 168)


class KernelChecks:
    """Results of phase kernels: each kernel call held against its plain
    version, timed with CUDA events, with its bound, every time and bound
    per launch; and per shape the call whose device time
    `phase_kernel_times` reads later."""

    def __init__(self):
        self.results, self.timed, self.failures = {}, [], []

    def hold(self, key, call, plain, kernel, n_events, n_plain, n_bytes,
             n_imads, launches=1, ref=None, pick=None, **extra):
        """`launches`: the kernel launches one call makes; n_bytes and
        n_imads are the call's; `ref`: plain()'s value where the caller
        has it already; n_plain = 0 leaves the plain version untimed;
        `pick`: compare only these lanes of the call's value (last axis),
        where plain() computes them alone (`sample_lanes`)."""
        import torch

        got = call()
        if pick is not None:
            got = got.index_select(-1, pick)
        ref = plain() if ref is None else ref
        torch.cuda.synchronize()
        mism, err = compare(got, ref)
        del got, ref
        bms, by = bound(n_bytes, n_imads)
        plain_ms = time_events(plain, n=n_plain, warm=1) / launches \
            if n_plain else None
        self.results[key] = dict(
            mismatches=mism, max_abs_err=err,
            events_ms=time_events(call, n=n_events) / launches,
            plain_ms=plain_ms, bound_ms=bms / launches, bound_by=by, **extra)
        self.timed.append((key, call, kernel, n_events, launches))
        say("kernels", kernel=key, **self.results[key])
        if mism:
            self.failures.append(key)


def sample_lanes(B: int, gen, device):
    """Sorted lanes of a batch of B at which a kernel is held to its plain
    version where that cannot run at the full width (the plain product's
    int64 [24, 24, B] partial products): the first and the last
    SAMPLED_LANES and SAMPLED_LANES random ones."""
    import torch

    rand = torch.randint(0, B, (SAMPLED_LANES,), generator=gen,
                         device=device)
    return torch.unique(torch.cat([
        torch.arange(SAMPLED_LANES, device=device), rand,
        torch.arange(B - SAMPLED_LANES, B, device=device)]))


def pow_exponent(label: str) -> int:
    from bls12_381_torch.params import FR_S, P, Q

    t = (Q - 1) >> FR_S
    return {"p-2": P - 2, "(p+1)/4": (P + 1) // 4, "(p-1)/2": (P - 1) // 2,
            "q-2": Q - 2, "(t-1)/2": (t - 1) // 2, "1": 1, "2": 2,
            "16": 16}[label]


def pow_rows(chk, usage, gen, device) -> None:
    """Phase kernels' rows of `pow_fixed` and `pow_fixed_fr` into `chk`
    (KernelChecks; `usage`: ptxas registers and spill bytes by kernel, the
    power's by threads per lane, which each row prints with the launch's):
    POW_EXPONENTS at POW_WIDTHS over pow_operand's edge lanes, one plain
    call per exponent at 1024 lanes whose first lanes (lane 9, random, for
    B = 1) hold the narrower launches, and at POW_SAMPLED, the first B
    lanes of a POW_WIDE operand, held on its sampled lanes below B; the
    plain version timed once per field, at 1024 lanes
    (1-2 s a call on the card).  The inversions timed at
    POW_TIMED_WIDTHS."""
    from bls12_381_torch import limbs
    from bls12_381_torch.kernels import mont

    n = mont.POW_LANES
    for wrapper, labels in POW_EXPONENTS.items():
        spec = limbs.FP if wrapper == "pow_fixed" else limbs.FR
        fn = getattr(mont, wrapper)
        a = pow_operand(spec, BATCH, gen, device)
        wide = pow_operand(spec, POW_WIDE, gen, device)
        pick = sample_lanes(POW_WIDE, gen, device)
        for label in labels:
            e = pow_exponent(label)
            ref = mont.pow_fixed_plain(spec, a, e)
            ref_wide = mont.pow_fixed_plain(spec, wide.index_select(1, pick),
                                            e)
            for B in POW_WIDTHS + POW_SAMPLED:
                if B in POW_SAMPLED:
                    below = pick < B
                    x, want, lanes_held = wide[:, :B].contiguous(), \
                        ref_wide[:, below], pick[below]
                else:
                    held = slice(0, B) if B > 1 else slice(9, 10)
                    x, want, lanes_held = a[:, held].contiguous(), \
                        ref[:, held], None
                timed = label in POW_TIMED and B in POW_TIMED_WIDTHS
                n_bytes, n_imads = pow_work(spec, e, B)
                tpi = mont.pow_threads_per_lane(spec, B)
                regs, spills = usage[f"{wrapper} t{tpi}"]
                chk.hold(f"{wrapper} {label} B={B}",
                         lambda fn=fn, x=x, e=e: fn(x, e),
                         lambda spec=spec, x=x, e=e: mont.pow_fixed_plain(
                             spec, x, e),
                         wrapper, 20 if timed else 2,
                         1 if timed and B == BATCH else 0, n_bytes, n_imads,
                         ref=want, pick=lanes_held, threads_per_lane=tpi,
                         lanes=n, blocks=-(-B // n),
                         shared_bytes=16 * spec.n_limbs * 2 * n,
                         registers=regs, spill_bytes=spills,
                         bytes_ms=bound(n_bytes, 0)[0],
                         ops_ms=bound(0, n_imads)[0])
            del ref, ref_wide
        del a, wide, pick


def fp2_pow_rows(chk, usage, gen, device) -> None:
    """Phase kernels' rows of `fp2_pow_fixed` into `chk` (KernelChecks;
    `usage`: ptxas registers and spill bytes by kernel): FP2_POW_EXPONENTS
    at FP2_POW_WIDTHS over the Fp2 edge lanes, one plain call per exponent
    at 1024 lanes whose first lanes (lane 9, random, for B = 1) hold the
    narrower launches, and at FP2_POW_WIDE lanes held on sampled lanes;
    the plain version timed once, at (p-1)/2 (2.4-3 s a call on the card).
    The square roots' exponents timed at FP2_POW_TIMED_WIDTHS."""
    import torch

    from bls12_381_torch.kernels import mont

    a0, a1 = fp2_pow_operand(BATCH, gen, device)
    w0, w1 = fp2_pow_operand(FP2_POW_WIDE, gen, device)
    pick = sample_lanes(FP2_POW_WIDE, gen, device)
    n = mont.FP2_POW_LANES
    regs, spills = usage["fp2_pow_fixed"]
    for label in FP2_POW_EXPONENTS:
        e = fp2_exponent(label)
        ref = torch.stack(mont.fp2_pow_plain(a0, a1, e))
        ref_wide = torch.stack(mont.fp2_pow_plain(
            w0.index_select(1, pick), w1.index_select(1, pick), e))
        for B in FP2_POW_WIDTHS + (FP2_POW_WIDE,):
            if B == FP2_POW_WIDE:
                x0, x1, want, lanes_held = w0, w1, ref_wide, pick
            else:
                held = slice(0, B) if B > 1 else slice(9, 10)
                x0, x1 = a0[:, held].contiguous(), a1[:, held].contiguous()
                want, lanes_held = ref[..., held], None
            key = f"fp2_pow_fixed {label} B={B}"
            timed = label in FP2_POW_TIMED and B in FP2_POW_TIMED_WIDTHS
            n_bytes, n_imads = fp2_pow_work(e, B)
            chk.hold(key, lambda x0=x0, x1=x1, e=e: torch.stack(
                         mont.fp2_pow_fixed(x0, x1, e)),
                     lambda x0=x0, x1=x1, e=e: torch.stack(
                         mont.fp2_pow_plain(x0, x1, e)),
                     "fp2_pow_fixed", 20 if timed else 2,
                     1 if key == f"fp2_pow_fixed (p-1)/2 B={BATCH}" else 0,
                     n_bytes, n_imads, ref=want, pick=lanes_held, lanes=n,
                     threads_per_lane=2, blocks=-(-B // n),
                     shared_bytes=FP2_POW_LANE_BYTES * n, registers=regs,
                     spill_bytes=spills, bytes_ms=bound(n_bytes, 0)[0],
                     ops_ms=bound(0, n_imads)[0])
        del ref, ref_wide
    del a0, a1, w0, w1, pick


def sqr_rows(chk, usage, gen, device, edges) -> None:
    """Phase kernels' rows of `sqr` into `chk` (KernelChecks; `usage`:
    ptxas registers and spill bytes by kernel; `edges`: the limb columns
    of 0, 1 and p-1): G = 1 and 3 at SQR_WIDTHS, lanes 0..4 the edges 0,
    1, p-1, R mod p, R^2 mod p where B > 5, the widest held on sampled
    lanes; timed at G = 1 and SQR_TIMED_WIDTHS and at G = 3 and the batch,
    each launch over rotating operand copies (from HBM)."""
    from bls12_381_torch import params
    from bls12_381_torch.kernels import mont

    P = params.P
    sqr_edges = edges + [edge_col(v, device) for v in (
        (1 << 384) % P, (1 << 768) % P)]
    regs, spills = usage["sqr"]
    per_block = mont.SQR_THREADS * mont.SQR_LANES_PER_THREAD
    for G in (1, 3):
        for B in SQR_WIDTHS:
            a = rand_fp((G, B), gen, device).transpose(0, 1).contiguous()
            if B > len(sqr_edges):
                for lane, col in enumerate(sqr_edges):
                    a[:, :, lane] = col
            timed = (G, B) == (3, BATCH) or G == 1 and B in SQR_TIMED_WIDTHS
            call, copies = rotating(mont.sqr, a) if timed else (
                lambda a=a: mont.sqr(a), 1)
            extra = {}
            if B == SQR_WIDTHS[-1]:
                lanes = sample_lanes(B, gen, device)
                plain, n_plain = (lambda a=a, i=lanes: mont.sqr_plain(
                    a.index_select(-1, i))), 0
                extra = {"pick": lanes, "sampled_lanes": len(lanes)}
            else:
                plain = lambda a=a: mont.sqr_plain(a)  # noqa: E731
                n_plain = (5 if B <= BATCH else 1) if timed else 0
            n_bytes, n_imads = 4 * G * B * 24 * 2, G * B * sqr_imads()
            chk.hold(f"sqr G={G} B={B}", call, plain, "sqr",
                     (200 if B <= BATCH else 20) if timed else 2, n_plain,
                     n_bytes, n_imads, operand_copies=copies,
                     threads=mont.SQR_THREADS,
                     lanes_per_thread=mont.SQR_LANES_PER_THREAD,
                     blocks=-(-G * B // per_block),
                     param_bytes=SQR_PARAM_BYTES, registers=regs,
                     spill_bytes=spills, bytes_ms=bound(n_bytes, 0)[0],
                     ops_ms=bound(0, n_imads)[0], **extra)
            del a, call


def phase_kernels(device, usage):
    """Each kernel against its plain version at the main paths' shapes
    (`usage`: ptxas registers and spill bytes by kernel, printed with the
    plan, power and row kernels' launches).

    Returns the results and, per shape, the call whose device time
    `phase_kernel_times` reads later: a profiler session may slow the
    host's launches for the rest of the process, so it follows the main
    paths' host-clock timings."""
    import numpy as np
    import torch

    from bls12_381_torch import entry, limbs, params
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.kernels import LAUNCHES, mont, plan_exec as pe
    from bls12_381_torch.ops import ntt
    from bls12_381_torch.pairing import gt

    P, Q = params.P, params.Q
    mods = {"g1": g1, "g2": g2, "gt": gt}
    MSM_PLAN_SHAPES = msm_plan_shapes()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    edges = [edge_col(v, device) for v in (0, 1, P - 1)]
    n_sm = mont.sm_count(device.index)
    chk = KernelChecks()

    def hold_rows(key, calls, n_events=20, n_plain=2, shape_of=None,
                  **extra):
        """Recorded or built `sop_rows` calls, replayed in one call against
        `sop_rows_plain`; shape_of(call) forces a launch shape."""
        def shape(c):
            return None if shape_of is None else shape_of(c)

        work = [rows_work(c) for c in calls]
        launch = [rows_launch(c, n_sm, usage, shape(c)) for c in calls]
        kernel = "sop_rows_fr" if calls[0][0].n_limbs == 16 else "sop_rows"
        chk.hold(key,
                 lambda: torch.cat([mont.sop_rows(*c, shape=shape(c))
                                    .reshape(-1) for c in calls]),
                 lambda: torch.cat([mont.sop_rows_plain(*c).reshape(-1)
                                    for c in calls]),
                 kernel, n_events, n_plain, sum(w[0] for w in work),
                 sum(w[1] for w in work), launches=len(calls),
                 **(launch[0] if len(calls) == 1 else {"shapes": sorted(
                     {(len(c[4]), c[2].shape[1], int(np.prod(c[5])),
                       *ln.values()) for c, ln in zip(calls, launch)},
                     key=str)}),
                 **extra)

    def call_of(spec, rows, groups, batch):
        """A `sop_rows` call over groups of (ia, ib) row-index pairs."""
        ia, ib = fold_tables(groups)
        return (spec, rows, ia, ib, np.array([len(g) for g in groups]),
                tuple(batch))

    # --- sop: T in {1, 2, 6, 8} at the pairing's batch (its one sop, the
    # norm of fp2_inv, is T = 2 there) and the MSM's widest products (its
    # scans and to_affine, T = 1 at 2^16), T = 1 at msm_g1_large's chunk
    # width (the plain version on sampled lanes); rows are views of
    # [T, 24, B]
    for B, terms in ((BATCH, (1, 2, 6, 8)),
                     (1 << MSM_LOG_N["g1"], (1, 2, 6, 8)),
                     (MSM_LARGE_SOP_WIDTH, (1,))):
        lanes = sample_lanes(B, gen, device) \
            if B == MSM_LARGE_SOP_WIDTH else None
        for T in terms:
            a = rand_fp((T, B), gen, device).transpose(0, 1).contiguous()
            b = rand_fp((T, B), gen, device).transpose(0, 1).contiguous()
            # lanes 0..2: every operand 0, 1, p-1 (lane 2 with T = 8 is the
            # all-(p-1) carry case)
            for lane, col in enumerate(edges):
                a[:, :, lane], b[:, :, lane] = col, col
            # lane 3: a = 1, b = p - 1; lane 4: a = p - 1, b = 0
            a[:, :, 3], b[:, :, 3] = edges[1], edges[2]
            a[:, :, 4], b[:, :, 4] = edges[2], edges[0]
            c = call_of(limbs.FP, list(a) + list(b),
                        [[(t, T + t) for t in range(T)]], (B,))
            call, copies = rotating(mont.sop, a, b)
            if lanes is None:
                plain, n_plain, extra = (
                    lambda a=a, b=b: mont.sop_plain(a, b)), 3, {}
            else:
                plain, n_plain, extra = (
                    lambda a=a, b=b, i=lanes: mont.sop_plain(
                        a.index_select(-1, i), b.index_select(-1, i))), 0, {
                    "pick": lanes, "sampled_lanes": len(lanes)}
            chk.hold(f"sop T={T} B={B}", call, plain, "sop_rows",
                     50, n_plain, 4 * B * 24 * (2 * T + 1), B * sop_imads(T),
                     operand_copies=copies, **rows_launch(c, n_sm, usage),
                     **extra)

    # --- sqr (mont_sqr.cuh)
    sqr_rows(chk, usage, gen, device, edges)

    # --- plan_exec: every plan at one lane, a ragged last tile and the
    # pairing's batch; the group-law plans also at the MSM's widths: add at
    # the segmented scan's top level (half the GLV / GLS lanes), double at
    # the window loop's single lane
    def hold_plan(make_plan, B, sampled=False):
        plan = pe.compile_plan(make_plan())
        ops = rand_fp((plan.n_in, B), gen, device).transpose(0, 1) \
            .contiguous()
        plan_edge_lanes(ops, P)
        lt, threads, smem = plan.launch_shape(B, n_sm)
        extra = {}
        if sampled:
            lanes = sample_lanes(B, gen, device)
            extra = {"pick": lanes, "sampled_lanes": len(lanes)}
        chk.hold(f"plan_exec {plan.name} B={B}",
                 lambda ops=ops, plan=plan: pe.plan_exec(ops, plan),
                 lambda ops=ops, plan=plan: pe.plan_exec_plain(
                     ops.index_select(-1, extra["pick"]) if sampled
                     else ops, plan),
                 "plan_exec", 20, 0 if sampled else 2,
                 96 * B * (plan.n_in + plan.n_out),
                 B * sum(sop_imads(t) for t in plan.sop_terms()),
                 nodes=len(plan.instr), groups=len(plan.groups),
                 phases=len(plan.phases), slots=plan.n_slots,
                 sop_nodes=len(plan.sop_terms()), lane_tile=lt,
                 blocks=-(-B // lt), threads=threads, smem_bytes=smem,
                 registers=usage["plan_exec"][0], **extra)

    msm_widths = {}
    for make_plan, B in MSM_PLAN_SHAPES:
        msm_widths.setdefault(make_plan, set()).add(B)
    # phase smul's widest launches of the add and double plans
    for make_plan, _ in MSM_PLAN_SHAPES[:4]:
        msm_widths[make_plan].add(SMUL_PLAN_WIDTH)
    for make_plan in pe.MAIN_PATH_PLANS + pe.GROUP_LAW_PLANS:
        for B in sorted({1, PLAN_RAGGED, BATCH} | msm_widths.get(make_plan,
                                                                 set())):
            hold_plan(make_plan, B)
    # msm_g1_large's widest group adds: the scans' top level at its chunk
    # widths (the plain version on sampled lanes)
    for B in MSM_LARGE_PLAN_WIDTHS:
        hold_plan(pe.g1_add_plan, B, sampled=True)

    # --- fold_planned: the line scaling's shape (G = 4, T = 1 over 68 x
    # 1024 lanes), a fold of Fp2 products (G = 8, T = 2) and uneven groups
    # up to T = 6 whose first group multiplies the all-(p-1) row by itself
    # six times; lanes 0..2 of every other row hold 0, 1, p-1; rows are
    # views of the [K, 24, B] stack, row 0 zeros for the padding terms
    for G, T, B, groups in FOLD_CASES:
        K = 1 + max(i for g in groups for pair in g for i in pair)
        ops = rand_fp((K, B), gen, device).transpose(0, 1).contiguous()
        for lane, col in enumerate(edges):
            ops[:, :, lane] = col
        ops[0] = 0
        if T == 6:
            ops[K - 1] = edges[2].unsqueeze(-1)
        ia, ib = fold_tables(groups)
        call, copies = rotating(
            lambda ops, ia=ia, ib=ib: mont.fold_planned(ops, ia, ib), ops)
        chk.hold(f"fold_planned G={G} T={T} B={B}", call,
                 lambda ops=ops, ia=ia, ib=ib: mont.fold_planned_plain(
                     ops, ia, ib),
                 "sop_rows", 50, 3, fold_bytes(B, groups),
                 B * sum(sop_imads(len(g)) for g in groups),
                 operand_copies=copies,
                 **rows_launch(call_of(limbs.FP, list(ops), groups, (B,)),
                               n_sm, usage))

    # --- the operand layouts the row kernel reads in place, at the paths'
    # sizes, and the one it copies: the pairing's line scaling (movedim
    # views of the [68, 3, 2, 24, B] coefficients, yp and xp expanded over
    # 68), a product scan level over 0::2 / 1::2 lanes, batch_inv's
    # inverted totals [24, n, 1] against [24, n, m], a [24, 1] constant,
    # and outer batch axes that do not collapse (copied_rows must be 1)
    coeffs = rand_fp((68 * 3 * 2 * BATCH,), gen, device).reshape(
        24, 68, 3, 2, BATCH).permute(1, 2, 3, 0, 4).contiguous()
    yp, xp = rand_fp((BATCH,), gen, device), rand_fp((BATCH,), gen, device)
    comp = [coeffs[:, i, j].movedim(1, 0)
            for i, j in ((0, 0), (0, 1), (2, 0), (2, 1))]
    n1, n2 = (1 << MSM_LOG_N[g] for g in ("g1", "g2"))
    scan = rand_fp((n1,), gen, device)
    others = rand_fp((16, n2), gen, device)
    totals = rand_fp((16, 1), gen, device)
    flat = rand_fp((n1,), gen, device)
    twisted = rand_fp((2, 3, n2), gen, device).transpose(1, 2)
    layouts = {
        "line scaling, movedim views and yp, xp expanded over 68":
            call_of(limbs.FP, comp + [yp.unsqueeze(1).expand(24, 68, BATCH),
                                      xp.unsqueeze(1).expand(24, 68, BATCH)],
                    [[(0, 4)], [(1, 4)], [(2, 5)], [(3, 5)]], (68, BATCH)),
        "scan level, 0::2 x 1::2": call_of(
            limbs.FP, [scan[:, 0::2], scan[:, 1::2]], [[(0, 1)]],
            (scan.shape[1] // 2,)),
        "[24, n, 1] x [24, n, m]": call_of(
            limbs.FP, [others, totals], [[(0, 1)]], (16, n2)),
        "[24, 1] constant x [24, B]": call_of(
            limbs.FP, [flat, edges[2].unsqueeze(-1)], [[(0, 1)]],
            (flat.shape[1],)),
        "non-affine [24, 3, 2, n], copied": call_of(
            limbs.FP, [twisted, rand_fp((3, 2, n2), gen, device)],
            [[(0, 1)], [(1, 1), (0, 0)]], (3, 2, n2)),
    }
    for label, c in layouts.items():
        LAUNCHES.reset()
        mont.sop_rows(*c)
        if LAUNCHES.copied_rows != (1 if "copied" in label else 0):
            fail(f"sop_rows {label}: {LAUNCHES.copied_rows} rows copied")
        hold_rows(f"sop_rows {label}", [c], n_events=50, n_plain=2)
    del coeffs, comp, scan, others, totals, flat, twisted, layouts

    # the calls of one pairing at batch 1024 as the pairing makes them:
    # its 31 folds (the line scaling, the inversions' and Frobenius maps'
    # Fp2 / Fp6 products; the kernels line's `fold_planned` row) and its
    # norm (fp2_inv, T = 2: the `sop` row), each replayed in one call, per
    # launch at the pairing's own mix
    from bls12_381_torch import pairing as pr

    _, _, p_aff, q_aff = pairing_inputs(device)
    calls = record_rows(lambda: pr.pairing(p_aff, q_aff))
    del p_aff, q_aff
    folds = [c for c in calls if len(c[4]) > 1]
    norms = [c for c in calls if len(c[4]) == 1]
    hold_rows(PAIRING_FOLDS, folds)
    hold_rows(PAIRING_NORM, norms, n_events=50, n_plain=3)

    # the chosen launch shape beside split = 1 and a 32-lane tile of one
    # thread per group, on the pairing's folds and norm and on the shapes
    # that set the policy (the device times come from phase kernel_times)
    def forced(split=None, tile=None):
        def shape(c):
            G, T = c[2].shape
            B = int(np.prod(c[5]))
            if tile:
                return tile, min(G, mont.SOP_THREADS // tile), 1
            return mont.sop_launch_shape(G, T, B, n_sm, split=split)
        return shape

    for G, T, B in ((6, 6, BATCH), (12, 3, BATCH), (2, 1, BATCH),
                    (4, 6, n2), (8, 2, n1)):
        label = f"G={G} T={T} B={B}"
        rows = list(rand_fp((2 * T, B), gen, device).transpose(0, 1))
        c = call_of(limbs.FP, rows, [[(t % (2 * T), (t + g) % (2 * T))
                                      for t in range(T)]
                                     for g in range(G)], (B,))
        for name, shape_of in (("chosen", None), ("split 1", forced(1)),
                               ("tile 32", forced(tile=32))):
            hold_rows(f"sop_rows {label} {name}", [c], n_events=50,
                      n_plain=1, shape_of=shape_of)
    for key, calls_ in ((PAIRING_FOLDS, folds), (PAIRING_NORM, norms)):
        for name, shape_of in (("split 1", forced(1)),
                               ("tile 32", forced(tile=32))):
            hold_rows(f"{key} {name}", calls_, shape_of=shape_of,
                      n_plain=0 if key == PAIRING_FOLDS else 1)
    del calls, folds, norms

    # the products of one msm_g1 as it makes them (to_affine's product
    # scans and per-lane products, the GLV split's beta x), replayed in one
    # call: per launch at the MSM's own mix (the kernels line's `sop` row
    # reads it beside the pairing's norm)
    fn, (pts, sc) = entry.msm_entry(MSM_LOG_N["g1"], "g1", seed=SEED,
                                    device=device)
    sops = [c for c in record_rows(lambda: fn(pts, sc))
            if c[0] is limbs.FP and len(c[4]) == 1]
    del fn, pts, sc
    hold_rows(MSM_SOPS, sops)
    del sops

    # the row kernel's calls of one call of each phase smul row at its
    # width, recorded and replayed by route (the kernels line puts their
    # ms per launch beside its sop, fold_planned and sop_fr rows): beta x,
    # the scalars' from_mont, the psi and Frobenius folds, eq's folds at
    # 4096 lanes, batch_normalize's scans and products at 10,000
    outs = {}
    for group, name, n in SMUL_ROWS:
        label = smul_label(group, name, n)
        args = smul_args(group, name, n, device, outs)
        fn = getattr(mods[group], name)

        def run(fn=fn, args=args, key=(group, name, n)):
            outs[key] = fn(*args)

        calls = record_rows(run)
        for route in ("sop", "fold_planned", "sop_fr"):
            mine = [c for c in calls if row_route(c) == route]
            if mine:
                hold_rows(smul_rows_key(route, label), mine)
        del args, calls
    del outs

    pow_rows(chk, usage, gen, device)
    fp2_pow_rows(chk, usage, gen, device)

    # --- Fr: sop_fr (T = 1, 2) and butterfly at B = 2^16 with edge rows,
    # and at the NTT's shapes: the 1/N scaling (T = 1, B = N) and a stage
    # (B = N/2)
    fr_edges = [edge_col(v, device, 16) for v in (0, 1, Q - 1, Q - 2)]
    for T, B in ((1, 1 << 16), (2, 1 << 16), (1, NTT_N)):
        a = rand_fr((T, B), gen, device).transpose(0, 1).contiguous()
        b = rand_fr((T, B), gen, device).transpose(0, 1).contiguous()
        # lanes 0..3: every operand 0, 1, q-1, q-2; lane 4: 1 x (q-1);
        # lane 5: (q-1) x 0
        for lane, col in enumerate(fr_edges):
            a[:, :, lane], b[:, :, lane] = col, col
        a[:, :, 4], b[:, :, 4] = fr_edges[1], fr_edges[2]
        a[:, :, 5], b[:, :, 5] = fr_edges[2], fr_edges[0]
        c = call_of(limbs.FR, list(a) + list(b),
                    [[(t, T + t) for t in range(T)]], (B,))
        call, copies = rotating(mont.sop_fr, a, b)
        chk.hold(f"sop_fr T={T} B={B}", call,
                 lambda a=a, b=b: mont.sop_fr_plain(a, b), "sop_rows_fr",
                 50, 3, 4 * B * 16 * (2 * T + 1), B * sop_imads(T, 8),
                 operand_copies=copies, **rows_launch(c, n_sm, usage))
    # the twiddle doublings of one ntt as it makes them: T = 1 at the widths
    # 1, 2, ..., N/4, the step constant a [16, 1] row read in place (the
    # kernels line's `sop_fr` row)
    x = entry.ntt_inputs(NTT_LOG_N, seed=SEED, device=device)
    doublings = record_rows(lambda: ntt.ntt(x))
    del x
    hold_rows(DOUBLINGS, doublings)
    del doublings
    for B in (1 << 16, NTT_N // 2):
        a, b, w = rand_fr((3, B), gen, device).unbind(1)
        # lanes 0..5: the rows whose lo takes the -q correction and whose
        # hi takes the +q correction (tests/test_device_fields.py:529-531);
        # lanes 6..9: every operand 0, 1, q-1, q-2
        rows = {"a": (0, 1, Q - 1, Q - 2, 0, Q - 1),
                "b": (Q - 1, 0, Q - 1, 1, 0, 1),
                "w": (Q - 1, 5, Q - 1, 1, 7, Q - 1)}
        for x, key in ((a, "a"), (b, "b"), (w, "w")):
            for lane, v in enumerate(rows[key]):
                x[:, lane] = edge_col(v, device, 16)
            for lane, col in enumerate(fr_edges):
                x[:, 6 + lane] = col
        a, b, w = a.contiguous(), b.contiguous(), w.contiguous()
        call, copies = rotating(mont.butterfly, a, b, w)
        chk.hold(f"butterfly B={B}", call,
                 lambda a=a, b=b, w=w: mont.butterfly_plain(a, b, w),
                 "butterfly", 50, 3, B * BUTTERFLY_BYTES,
                 B * BUTTERFLY_IMADS, operand_copies=copies)
    if chk.failures:
        fail(f"kernel and plain version disagree: {chk.failures}")
    return chk.results, chk.timed


# ---------------------------------------------------------------------------
# The device hash expanders
# ---------------------------------------------------------------------------


def xmd_cases():
    """(msg_len, len_in_bytes, dst_len) of phase hashes: every message
    length at hash_to_curve_g2's 256 bytes under the bench DST (b0 over one,
    two and three blocks), every output length under BLS_DST and every DST
    length at 256 bytes (300: reduced on the host), these with 32-byte
    messages, and the other hash to curve rows' 32 bytes to 128 and to 64
    under the bench DST."""
    d10 = len(HASH_DST)
    cases = [(m, 256, d10) for m in XMD_MSG_LENS]
    cases += [(32, n, len(BLS_DST)) for n in XMD_OUT_LENS]
    cases += [(32, 256, d) for d in XMD_DST_LENS]
    cases += [(32, 128, d10), (32, 64, d10)]
    return list(dict.fromkeys(cases))


def shake_cases():
    """(rate, msg_len, out_len) of phase hashes: messages of 0, r-1, r,
    r+1 and 2r bytes and outputs of 1, r, r+1 and 512 bytes at both
    rates."""
    return [(r, m, o) for r in SHAKE_RATES
            for m in (0, r - 1, r, r + 1, 2 * r) for o in (1, r, r + 1, 512)]


def phase_hashes(device, usage, results, timed) -> None:
    """The hash kernels (csrc/sha256.cu, csrc/keccak.cu) against their
    plain versions on the card and against hashlib / hostmath, byte for
    byte on every lane, then timed (`KernelChecks`; their device times
    come from phase kernel_times).

    Every case of `xmd_cases` (`expand_message_xmd_sha256`), every message
    length of XMD_MSG_LENS (`sha256`), every case of `shake_cases`
    (`shake`), and expand_message_xof_shake at both security levels with
    DSTs of 10 and 300 bytes and 128 and 256 bytes out run at B = 1, 33
    and 256 (the plain version at 256, the narrower launches against its
    first lanes); at 2^16 too (the plain version at 2^16): the XMD cases
    of 32-byte messages with up to 256 bytes out, every digest, SHAKE of
    r + 1 bytes to 512 and the XOF with the bench DST to 256 bytes.  Timed
    at HASH_TIMED_WIDTHS and at one lane (one thread's chain): the G2
    hash's XMD (32 bytes to 256 under the bench DST), the digest of 32
    bytes and the SHAKE-128 XOF of the XMD's shape."""
    import hashlib

    import numpy as np
    import torch

    from bls12_381_torch import hostmath as hm
    from bls12_381_torch.kernels import keccak, sha256

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    big = max(HASH_WIDTHS)
    narrow = [w for w in HASH_WIDTHS if w < big]
    msgs = {}

    def messages(length):
        """uint8 [2^16, length] on the card, and its host copy."""
        if length not in msgs:
            m = rng.integers(0, 256, (big, length), dtype=np.uint8)
            msgs[length] = (torch.from_numpy(m).to(device), m)
        return msgs[length]

    dsts = {len(HASH_DST): HASH_DST, len(BLS_DST): BLS_DST}
    for d in XMD_DST_LENS:
        dsts.setdefault(d, bytes(rng.integers(0, 256, d, dtype=np.uint8)))
    failures, checked = [], collections.Counter()

    def check(label, kernel, plain, host, at_big):
        """kernel(B) at each width against plain(widest)'s first lanes and
        host(i) on every lane; at_big: 2^16 as well.  Returns the narrow
        widths' reference."""
        for widths in [narrow] + ([[big]] if at_big else []):
            ref = plain(max(widths)).cpu().numpy()
            for B in widths:
                hold(f"{label} B={B}", kernel(B), ref, host, B)
            if widths is narrow:
                narrow_ref = ref
        return narrow_ref

    def hold(label, got, ref, host, B):
        got = got.cpu().numpy()
        bad = int((got != ref[:B]).any(1).sum())
        bad += sum(bytes(got[i]) != host(i) for i in range(B))
        checked[label.split()[0]] += B
        if bad:
            failures.append(f"{label}: {bad} lanes")

    def shifted(t, off: int):
        """t's rows copied into a buffer at `off` bytes past its start (a
        256-byte boundary), so that no row starts 16-byte aligned."""
        B, n = t.shape
        view = torch.empty(B * n + off, dtype=torch.uint8,
                           device=t.device)[off:].view(B, n)
        view.copy_(t)
        return view

    # the XMD kernel's instances by message load width and its output
    # stores, over the calls held here: each must run
    io = collections.Counter()

    for m_len, n, d in xmd_cases():
        t, m = messages(m_len)
        dst = dsts[d]
        label = f"xmd_sha256 msg={m_len} out={n} dst={d}"
        ref = check(label,
                    lambda B: sha256.expand_message_xmd_sha256(t[:B], dst, n),
                    lambda B: sha256.expand_message_xmd_sha256_plain(
                        t[:B], dst, n),
                    lambda i: hm.expand_message_xmd(bytes(m[i]), dst, n),
                    m_len == 32 and n <= 256)
        io[("load", sha256.io_width(t.data_ptr(), m_len))] += 1
        io[("store", sha256.io_width(0, n))] += 1
        # the same rows at 4 and 1 bytes past an aligned start: the
        # 4-byte and the byte load instances
        for off in (4, 1) if m_len % 4 == 0 else ():
            for B in narrow:
                x = shifted(t[:B], off)
                io[("load", sha256.io_width(x.data_ptr(), m_len))] += 1
                hold(f"{label} view+{off} B={B}",
                     sha256.expand_message_xmd_sha256(x, dst, n), ref,
                     lambda i: hm.expand_message_xmd(bytes(m[i]), dst, n), B)
    missing = {(k, w) for k in ("load", "store") for w in (16, 4, 1)} - set(io)
    if missing:
        failures.append(f"xmd_sha256 I/O widths never run: {sorted(missing)}")
    for m_len in XMD_MSG_LENS:
        t, m = messages(m_len)
        check(f"sha256 msg={m_len}", lambda B: sha256.sha256(t[:B]),
              lambda B: sha256.sha256_plain(t[:B]),
              lambda i: hashlib.sha256(bytes(m[i])).digest(), True)
    for rate, m_len, out in shake_cases():
        t, m = messages(m_len)
        name = {168: "shake_128", 136: "shake_256"}[rate]
        check(f"shake rate={rate} msg={m_len} out={out}",
              lambda B: keccak.shake(t[:B], out, rate),
              lambda B: keccak.shake_plain(t[:B], out, rate),
              lambda i: hashlib.new(name, bytes(m[i])).digest(out),
              (m_len, out) == (rate + 1, 512))
    t, m = messages(32)
    for bits, name in ((128, "shake_128"), (256, "shake_256")):
        for d in (len(HASH_DST), 300):
            for n in (128, 256):
                dst = dsts[d]
                check(f"shake xof{bits} dst={d} out={n}",
                      lambda B: keccak.expand_message_xof_shake(
                          t[:B], dst, n, bits),
                      lambda B: keccak.expand_message_xof_shake_plain(
                          t[:B], dst, n, bits),
                      lambda i: hm.expand_message_xof(
                          bytes(m[i]), dst, n, hash_name=name),
                      (d, n) == (len(HASH_DST), 256))
    say("hashes", lanes_checked=dict(checked), xmd_cases=len(xmd_cases()),
        xmd_io_widths={f"{k}{w}": c for (k, w), c in sorted(io.items())},
        shake_cases=len(shake_cases()), mismatches=failures,
        seconds=time.perf_counter() - t_phase)
    if failures:
        fail(f"hash kernels differ from their plain versions or the host: "
             f"{failures}")

    # timed: the main path's shapes at HASH_TIMED_WIDTHS and one lane (the
    # plain versions up to 256 lanes)
    chk = KernelChecks()
    d10 = len(HASH_DST)
    for B in (1,) + HASH_TIMED_WIDTHS:
        x = t[:B]
        n_plain = 1 if B < big else 0
        launch = {"threads": 128, "blocks": -(-B // 128)}
        n_bytes, n_ops = xmd_work(B, 32, 256, d10)
        chk.hold(f"xmd_sha256 msg=32 out=256 dst={d10} B={B}",
                 lambda x=x: sha256.expand_message_xmd_sha256(
                     x, HASH_DST, 256).T,
                 lambda x=x: sha256.expand_message_xmd_sha256_plain(
                     x, HASH_DST, 256).T,
                 "xmd_sha256", 20, n_plain, n_bytes, n_ops,
                 registers=usage["xmd_sha256"][0],
                 spill_bytes=usage["xmd_sha256"][1],
                 load=sha256.io_width(x.data_ptr(), 32),
                 store=sha256.io_width(0, 256),
                 param_bytes=len(sha256.xmd_params(HASH_DST, 256, 32)),
                 instance_registers={k: usage[k] for k in usage
                                     if k.startswith("xmd_sha256")},
                 bytes_ms=bound(n_bytes, 0)[0], ops_ms=bound(0, n_ops)[0],
                 **launch)
        chk.hold(f"sha256 msg=32 B={B}", lambda x=x: sha256.sha256(x).T,
                 lambda x=x: sha256.sha256_plain(x).T, "sha256", 20,
                 n_plain, B * (32 + 32),
                 B * sha256_blocks(32) * SHA256_COMPRESSION_OPS,
                 registers=usage["sha256"][0],
                 spill_bytes=usage["sha256"][1], **launch)
        chk.hold(f"shake xof128 msg=32 out=256 dst={d10} B={B}",
                 lambda x=x: keccak.expand_message_xof_shake(
                     x, HASH_DST, 256).T,
                 lambda x=x: keccak.expand_message_xof_shake_plain(
                     x, HASH_DST, 256).T,
                 "shake", 20, n_plain,
                 *shake_work(B, 32 + 2 + d10 + 1, 32, 256, 168),
                 registers=usage["shake"][0],
                 spill_bytes=usage["shake"][1], **launch)
    if chk.failures:
        fail(f"hash kernel and plain version disagree: {chk.failures}")
    results.update(chk.results)
    timed.extend(chk.timed)


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------


def load_points(a_idx, b_idx):
    """Affine G1 [a]G1 and G2 [b]G2 from the uncompressed test vectors
    (entry i is [i]G; entry 0 the identity)."""
    g1 = (VECTORS / "g1_uncompressed_valid_test_vectors.dat").read_bytes()
    g2 = (VECTORS / "g2_uncompressed_valid_test_vectors.dat").read_bytes()

    def fe(raw):
        return int.from_bytes(raw, "big")

    def g1_at(i):
        e = g1[96 * i: 96 * i + 96]
        if e[0] & 0x40:
            return (0, 0, True)
        return (fe(bytes([e[0] & 0x1F]) + e[1:48]), fe(e[48:96]), False)

    def g2_at(i):
        e = g2[192 * i: 192 * i + 192]
        if e[0] & 0x40:
            return ((0, 0), (0, 0), True)
        x1 = fe(bytes([e[0] & 0x1F]) + e[1:48])
        return ((fe(e[48:96]), x1), (fe(e[144:192]), fe(e[96:144])), False)

    return [g1_at(i) for i in a_idx], [g2_at(i) for i in b_idx]


def encode(ps, qs, device):
    import torch

    from bls12_381_torch.fields import fp, tower as tw

    p_aff = (fp.from_ints([p[0] for p in ps], device=device),
             fp.from_ints([p[1] for p in ps], device=device),
             torch.tensor([p[2] for p in ps], device=device))
    q_aff = (tw.fp2_from_ints([q[0] for q in qs], device=device),
             tw.fp2_from_ints([q[1] for q in qs], device=device),
             torch.tensor([q[2] for q in qs], device=device))
    return p_aff, q_aff


def fp12_rows(f):
    import torch

    return torch.stack([c for c6 in f for c2 in c6 for c in c2])  # [12,L,B]


def take_lanes(aff, lanes, device):
    def t(x):
        return x[..., lanes].to(device) if x.dim() > 1 else \
            x[lanes].to(device)

    x, y, inf = aff
    if isinstance(x, tuple):
        return ((t(x[0]), t(x[1])), (t(y[0]), t(y[1])), t(inf))
    return (t(x), t(y), t(inf))


def zero_launches() -> dict:
    """Every key of `LAUNCHES.snapshot()` at 0: the base of each schedule
    below, so that a schedule names every counter a run reads."""
    from bls12_381_torch.kernels import LaunchCounts

    return LaunchCounts().snapshot()


def expected_launches():
    """The launches of one pairing by kernel, from the static schedules
    (its plans are not counted by name)."""
    import importlib

    from bls12_381_torch.fields import tower as tw

    pm = importlib.import_module("bls12_381_torch.pairing.pairing")
    k = tw.CYCLO_FUSE
    per_exp_z = sum(n // k + n % k + (1 if mul else 0)
                    for n, mul in pm._X_RUNS)
    # final exp outside the five exp-by-|z|: 10 fp12_mul + 1 fp12_sqr
    plans = 2 * pm.N_COEFFS + 5 * per_exp_z + 11
    # folds (fold_planned): the Miller loop's line scaling; in fp12_inv two
    # fp6_mul_many, fp6_inv's three folds and fp2_inv's two products; three
    # per fp12_frobenius, eight of them in the final exponentiation
    folds = 1 + 5 + 1 + 3 * 8
    # fp2_inv in fp12_inv: the norm (one sop) and its fp.inv, one
    # pow_fixed (no sqr chain)
    out = zero_launches()
    del out["plan_exec_by_plan"]
    return {**out, "plan_exec": plans, "sop": 1, "fold_planned": folds,
            "pow_fixed": 1}


def pairing_inputs(device):
    """The pairing's batch: [a]G1, [b]G2 with a, b < 1000 from the seed,
    fixed lanes first (e(G1, G2), identities, equal products)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    a_idx = [int(v) for v in rng.integers(0, 1000, BATCH)]
    b_idx = [int(v) for v in rng.integers(0, 1000, BATCH)]
    fixed = [(1, 1), (0, 5), (7, 0), (0, 0), (2, 3), (3, 2), (6, 1), (1, 6),
             (10, 20), (20, 10), (40, 5)]
    for lane, (a, b) in enumerate(fixed):
        a_idx[lane], b_idx[lane] = a, b
    return (a_idx, b_idx) + encode(*load_points(a_idx, b_idx), device)


def phase_main(device):
    import torch

    from bls12_381_torch import limbs
    from bls12_381_torch import pairing as pr
    from bls12_381_torch.fields import tower as tw

    t0 = time.perf_counter()
    a_idx, b_idx, p_aff, q_aff = pairing_inputs(device)
    torch.cuda.synchronize()
    say("main", inputs_seconds=time.perf_counter() - t0, batch=BATCH)

    # the main path, counted
    # held: the inputs, phase 3's operands
    counts, first_s, peak, held, out = counted_call(
        lambda: pr.pairing(p_aff, q_aff))
    expected = expected_launches()
    say("main", first_pairing_seconds=first_s, launches=counts,
        expected=expected, pairing_peak_bytes=peak, held_bytes=held)
    for name, n in expected.items():
        if n > 0 and counts[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    # copied_rows = 0: every operand of the pairing is read in place
    if any(counts[name] != n for name, n in expected.items()):
        fail(f"launch counts {counts} differ from the schedule {expected}")

    # correctness
    rows = fp12_rows(out)  # [12, L, B]
    relic = json.loads((VECTORS / "ref_constants.json").read_text())[
        "relic_pairing_fp12"]
    relic = [int(v, 16) for v in relic]
    lane0 = [int(limbs.to_ints(limbs.FP, rows[i, :, 0])) for i in range(12)]
    if lane0 != relic:
        fail("lane e(G1, G2) differs from the RELIC value")
    one = fp12_rows(tw.fp12_one((1,), device))[..., 0]
    n_ident = 0
    by_product = {}
    for lane, (a, b) in enumerate(zip(a_idx, b_idx)):
        if a == 0 or b == 0:
            n_ident += 1
            if not torch.equal(rows[..., lane], one):
                fail(f"identity lane {lane} is not Fp12 one")
        else:
            by_product.setdefault(a * b, []).append(lane)
    n_groups = 0
    for prod, lanes in by_product.items():
        if len(lanes) > 1:
            n_groups += 1
            ref = rows[..., lanes[0]]
            for lane in lanes[1:]:
                if not torch.equal(rows[..., lane], ref):
                    fail(f"lanes {lanes[0]} and {lane} (a*b = {prod}) differ")
    say("main", relic_lane=True, identity_lanes=n_ident,
        equal_product_groups=n_groups)

    # stage times (host clock around synchronized work, after the warm-up
    # run above; before the CPU-threaded check and the profiler sessions,
    # so that neither can slow the host's launches here)
    prep = pr.prepare_g2(q_aff)
    f = pr.miller_loop_batched(p_aff, prep)
    stages = {
        "prepare_g2": host_times(lambda: pr.prepare_g2(q_aff)),
        "miller_loop_batched": host_times(
            lambda: pr.miller_loop_batched(p_aff, prep)),
        "final_exponentiation": host_times(
            lambda: pr.final_exponentiation(f)),
        "pairing": host_times(lambda: pr.pairing(p_aff, q_aff)),
    }
    med = {k: statistics.median(w) for k, (w, _) in stages.items()}
    say("main", stage_seconds={k: w for k, (w, _) in stages.items()},
        median_seconds=med, pairings_per_s=BATCH / med["pairing"],
        host_cpu_share={k: sum(c) / sum(w)
                        for k, (w, c) in stages.items()})

    check_lanes = [0, 4, BATCH // 2, BATCH - 1]
    t0 = time.perf_counter()
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    cpu_out = pr.pairing(take_lanes(p_aff, check_lanes, "cpu"),
                         take_lanes(q_aff, check_lanes, "cpu"))
    torch.set_num_threads(1)
    plain_s = time.perf_counter() - t0
    if not torch.equal(fp12_rows(cpu_out), rows[..., check_lanes].cpu()):
        fail(f"lanes {check_lanes} differ from the plain path")
    say("main", plain_path_lanes=check_lanes,
        plain_path_cpu_seconds=plain_s, all_checks="passed")
    return counts, med, (p_aff, q_aff)


def phase_kernel_times(results, timed) -> None:
    """Each kernel's device time per launch at the shapes of phase kernels,
    into results[key]["ms"]: the mean duration of its launches (of a
    call's launches, for a call that makes several) as the profiler
    records them on the card.  (CUDA events around back-to-back
    calls time the host's issue rate for kernels that finish faster than
    Python and ctypes can launch them.)  One profiler session runs every
    shape's launches in turn; each kernel's events, in order, are split
    by shape."""
    import torch

    def run_all():
        for _, call, _, n, _ in timed:
            for _ in range(n):
                call()
            torch.cuda.synchronize()

    evs = sorted(device_events(run_all), key=lambda ev: ev[1])
    durs = {}
    for kernel in {t[2] for t in timed}:
        durs[kernel] = [(end - start, name) for name, start, end in evs
                        if kernel_of(name) == kernel]
        want = sum(n * per for _, _, k, n, per in timed if k == kernel)
        if len(durs[kernel]) != want:
            fail(f"profiler recorded {len(durs[kernel])} launches of "
                 f"{kernel}, not {want}")
    for key, _, kernel, n, per in timed:
        mine, durs[kernel] = durs[kernel][:n * per], durs[kernel][n * per:]
        results[key]["ms"] = sum(d for d, _ in mine) / (n * per) / 1e3
        if "threads_per_lane" in results[key]:  # the instance it launched
            shape = (f", {results[key]['threads_per_lane']}, "
                     f"{results[key]['lanes']}>")
            if kernel.startswith("pow_fixed") and not all(
                    shape in name for _, name in mine):
                fail(f"{key}: launched {mine[0][1][:80]}, not the "
                     f"instance <..{shape}")
        say("kernel_times", kernel=key, ms=results[key]["ms"],
            events_ms=results[key]["events_ms"],
            bound_ms=results[key]["bound_ms"])


def route_cases(device):
    """The folds `phase_fold_routes` times: (what runs such a fold, G lists
    of (a, b) Fp operand pairs) -- the paths' folds of two and three
    groups over separate [24, B] rows, T = 7, 8, the pairing's norm, and
    two in their paths' own layouts: the line scaling (movedim views of
    the [68, 3, 2, 24, 1024] coefficients, yp and xp expanded over 68) and
    a product scan level of msm_g1's to_affine (0::2 x 1::2 lanes)."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    cases = []
    for label, B, idx in (
            ("fp2_inv / to_affine products", BATCH, [[(1, 3)], [(2, 3)]]),
            ("msm_g1 to_affine x, y", 1 << MSM_LOG_N["g1"],
             [[(1, 3)], [(2, 3)]]),
            ("msm_g2 psi Fp2 product", 1 << MSM_LOG_N["g2"],
             [[(1, 3), (5, 4)], [(1, 4), (2, 3)]]),
            ("g1 is_on_curve", BATCH, [[(1, 1)], [(2, 2)], [(3, 3)]]),
            ("G=4 T=7", BATCH, [[(1 + (g + t) % 8, 9 + (g * t) % 8)
                                 for t in range(7)] for g in range(4)]),
            ("G=4 T=8", BATCH, [[(1 + (g + t) % 8, 9 + (g * t) % 8)
                                 for t in range(8)] for g in range(4)]),
            ("pairing norm (fp2_inv, one group)", BATCH,
             [[(1, 1), (2, 2)]])):
        K = max(i for g in idx for pair in g for i in pair)
        rows = [None] + list(rand_fp((K, B), gen, device).unbind(1))
        cases.append((label, [[(rows[a], rows[b]) for a, b in g]
                              for g in idx]))
    coeffs = rand_fp((68 * 3 * 2 * BATCH,), gen, device).reshape(
        24, 68, 3, 2, BATCH).permute(1, 2, 3, 0, 4).contiguous()
    comp = [coeffs[:, i, j].movedim(1, 0)
            for i, j in ((0, 0), (0, 1), (2, 0), (2, 1))]
    ypb, xpb = (rand_fp((BATCH,), gen, device).unsqueeze(1).expand(
        24, 68, BATCH) for _ in range(2))
    cases.append(("pairing line scaling (movedim views, yp / xp expanded)",
                  [[(comp[0], ypb)], [(comp[1], ypb)], [(comp[2], xpb)],
                   [(comp[3], xpb)]]))
    t = rand_fp((1 << MSM_LOG_N["g1"],), gen, device)
    cases.append(("msm_g1 scan level (0::2 x 1::2, one group)",
                  [[(t[:, 0::2], t[:, 1::2])]]))
    return cases


def stacked_route(groups):
    """An Fp fold as the port ran it before the row kernel: a fold of two
    or more groups stacks each distinct operand once after a zero row into
    [K, 24, B] for `mont.fold_planned` (short groups pad with row 0); a
    single sum stacks its operands per term and transposes them into
    [T, 24, B] for `mont.sop`.  The same kernel runs on the result."""
    import numpy as np
    import torch

    from bls12_381_torch.kernels import mont

    batch = torch.broadcast_shapes(
        *[x.shape[1:] for g in groups for pair in g for x in pair])
    full = (24,) + tuple(batch)
    if len(groups) == 1:
        def stack(i):
            x = torch.stack([pair[i].expand(full) for pair in groups[0]], 1)
            return x.transpose(0, 1).reshape(len(groups[0]), 24, -1) \
                .contiguous()
        return [mont.sop(stack(0), stack(1)).reshape(full)]
    ops = [torch.zeros(full, dtype=torch.int32,
                       device=groups[0][0][0].device)]
    ids = {}

    def reg(x):
        if id(x) not in ids:
            ids[id(x)] = len(ops)
            ops.append(x.expand(full))
        return ids[id(x)]

    t = max(len(g) for g in groups)
    ia = np.zeros((len(groups), t), np.int32)
    ib = np.zeros((len(groups), t), np.int32)
    for gi, g in enumerate(groups):
        for ti, (a, b) in enumerate(g):
            ia[gi, ti], ib[gi, ti] = reg(a), reg(b)
    stack = torch.stack(ops).reshape(len(ops), 24, -1)
    return list(mont.fold_planned(stack, ia, ib).reshape(
        (len(groups),) + full).unbind(0))


def phase_fold_routes(device) -> None:
    """An Fp fold's two routes on the same operands: in place (the
    caller's tensors as the row kernel's rows: `limbs.sop_fold`, which
    takes `sum_of_products` for one group) and stacked (`stacked_route`:
    the operands copied into one tensor first, then the same kernel), at
    `route_cases`: equal values, and per call the device ms of all its
    device work (kernels and copies; profiler, device-side events) and the
    issue ms (CUDA events around back-to-back calls)."""
    import torch

    from bls12_381_torch import limbs

    routes = {"in_place": lambda groups: limbs.sop_fold(limbs.FP, groups),
              "stacked": stacked_route}
    for label, groups in route_cases(device):
        outs = {k: torch.stack(fn(groups)) for k, fn in routes.items()}
        if not torch.equal(outs["in_place"], outs["stacked"]):
            fail(f"fold routes disagree at {label}")
        res = {"case": label, "G": len(groups),
               "T": max(map(len, groups)), "B": outs["stacked"][0, 0].numel()}
        n = 20
        for k, fn in routes.items():
            res[f"{k}_issue_ms"] = time_events(lambda fn=fn: fn(groups), n=n)

            def run(fn=fn):
                for _ in range(n):
                    fn(groups)

            evs = device_events(run)
            res[f"{k}_device_ms"] = sum(e - s for _, s, e in evs) / n / 1e3
            res[f"{k}_device_launches"] = len(evs) / n
        for m in ("device_ms", "issue_ms"):
            res[f"in_place_over_stacked_{m.split('_')[0]}"] = (
                res[f"in_place_{m}"] / res[f"stacked_{m}"])
        say("fold_routes", **res)


def limb_ints(t) -> list:
    """[16, n] Fr limbs (any device) -> n Python ints, as stored (the
    Montgomery values), through little-endian bytes."""
    import numpy as np

    raw = np.ascontiguousarray(t.cpu().numpy().astype("<u2").T).tobytes()
    return [int.from_bytes(raw[i:i + 32], "little")
            for i in range(0, len(raw), 32)]


def horner(cs, z: int, q: int) -> int:
    acc = 0
    for c in reversed(cs):
        acc = (acc * z + c) % q
    return acc


def expected_ntt_launches(n: int, inverse: bool) -> dict:
    """Kernel launches of one transform of N = n lanes, from the schedule
    of ops/ntt.py: one `butterfly` per stage (log2 N stages); the twiddle
    table doubles from 1 to N/2 columns, one `sop_fr` per doubling
    (log2 N - 1); the inverse adds one `sop_fr` for the 1/N scaling."""
    log_n = n.bit_length() - 1
    return {**zero_launches(), "butterfly": log_n,
            "sop_fr": log_n - 1 + int(inverse)}


def phase_ntt(device):
    """The NTT slice at N = 2^20, batch 1, coefficients from
    `entry.ntt_inputs`: launch counts against the static schedule, the
    five checks, and host-clock times (before any profiler session)."""
    import numpy as np
    import torch

    from bls12_381_torch import entry, params
    from bls12_381_torch.kernels import LAUNCHES
    from bls12_381_torch.ops import ntt

    Q = params.Q
    R = 1 << 256
    fn, (x,) = entry.ntt_entry(NTT_LOG_N, seed=SEED, device=device)
    torch.cuda.synchronize()

    # the slice's path, counted: one ntt, one intt
    counts, first_s, peak, held, y = counted_call(lambda: fn(x))
    LAUNCHES.reset()
    back = ntt.intt(y)
    torch.cuda.synchronize()
    counts_inv = LAUNCHES.snapshot()
    say("ntt", n=NTT_N, first_ntt_seconds=first_s, launches_ntt=counts,
        launches_intt=counts_inv, ntt_peak_bytes=peak, held_bytes=held)
    for got, inverse in ((counts, False), (counts_inv, True)):
        if got != expected_ntt_launches(NTT_N, inverse):
            fail(f"NTT launch counts {got} differ from the schedule "
                 f"{expected_ntt_launches(NTT_N, inverse)}")

    # 1. intt(ntt(x)) == x on every lane
    if not torch.equal(back, x):
        fail("intt(ntt(x)) != x")
    # 2. eight entries against the host's Horner evaluation at omega^k
    # (the transform is linear, so Montgomery values evaluate directly)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    ks = [0, NTT_N - 1] + [int(k) for k in rng.integers(1, NTT_N - 1, 6)]
    omega = pow(params.FR_ROOT_OF_UNITY, 1 << (params.FR_S - NTT_LOG_N), Q)
    cs = limb_ints(x)
    got = limb_ints(y[:, ks])
    for k, g in zip(ks, got):
        if g != horner(cs, pow(omega, k, Q), Q):
            fail(f"ntt(x)[{k}] differs from the host's evaluation")
    # 3. a 2^12 NTT on the card equals the plain path on the CPU
    small = x[:, :1 << 12]
    if not torch.equal(ntt.ntt(small).cpu(), ntt.ntt(small.cpu())):
        fail("the 2^12 NTT on the card differs from the CPU path")
    # 4. poly_mul of two degree-(2^19 - 1) polynomials: c(r) = a(r) b(r)
    # at four seeded points; on Montgomery values c_m(r) R = a_m(r) b_m(r)
    a = entry.ntt_inputs(NTT_LOG_N - 1, seed=SEED + 1, device=device)
    b = entry.ntt_inputs(NTT_LOG_N - 1, seed=SEED + 2, device=device)
    LAUNCHES.reset()
    c = ntt.poly_mul(a, b)
    torch.cuda.synchronize()
    counts_poly = LAUNCHES.snapshot()
    fwd = expected_ntt_launches(NTT_N, False)
    inv = expected_ntt_launches(NTT_N, True)
    if (counts_poly["butterfly"] != 2 * fwd["butterfly"] + inv["butterfly"]
            or counts_poly["sop_fr"] != 2 * fwd["sop_fr"] + 1
            + inv["sop_fr"]):
        fail(f"poly_mul launch counts {counts_poly} differ from the "
             "schedule (two ntt, one product, one intt)")
    if c.shape != (16, NTT_N):
        fail(f"poly_mul shape {tuple(c.shape)}")
    ai, bi, ci = limb_ints(a), limb_ints(b), limb_ints(c)
    for r in (int(v) for v in rng.integers(2, 1 << 62, 4)):
        if horner(ci, r, Q) * R % Q != horner(ai, r, Q) * horner(bi, r, Q) \
                % Q:
            fail(f"poly_mul: c({r}) != a({r}) b({r})")
    say("ntt", checks="passed", eval_points=ks,
        launches_poly_mul=counts_poly,
        host_check_seconds=time.perf_counter() - t0)
    del back, c, small

    # host clock around synchronized work, after the warm-up runs above
    stages = {"ntt": host_times(lambda: fn(x)),
              "intt": host_times(lambda: ntt.intt(y)),
              "poly_mul": host_times(lambda: ntt.poly_mul(a, b))}
    med = {k: statistics.median(w) for k, (w, _) in stages.items()}
    say("ntt", stage_seconds={k: w for k, (w, _) in stages.items()},
        median_seconds=med,
        host_cpu_share={k: sum(c) / sum(w) for k, (w, c) in stages.items()})
    return counts, med, x


def expected_msm_launches(group: str, n: int, c: int, split: bool = True):
    """Kernel launches of one msm over n >= 16 points with window c, from
    the schedule of ops/msm.py: from_mont of the scalars (one sop_fr); the
    z inversions of to_affine (`batch_inv`: two product scans of 2 lg n
    products, one Fp inversion (one pow_fixed), two products; G2 adds the
    norm, one sop, and two products, one fold) and its x, y products (one
    fold_planned);
    the GLV split's beta x (one sop) or the GLS split's three psi (one
    fold of two Fp2 products each); then per window of
    the signed digits the segmented scan (2 lg m adds over m lanes), the
    bucket sum (a suffix scan and a halving tree over 2^(c-1) buckets:
    3 (c - 1) adds), c doublings and one add."""
    def lg(m):
        return (m - 1).bit_length()

    inv = 4 * lg(n) + 2
    lanes, bits = {("g1", True): (2 * n, 128), ("g2", True): (4 * n, 64)}.get(
        (group, split), (n, 255))
    windows = -(-(bits + 1) // c)
    adds = windows * (2 * lg(lanes) + 3 * (c - 1) + 1)
    if group == "g1":
        sops, folds = inv + int(split), 1
    else:
        sops, folds = 1 + inv, 2 + (3 if split else 0)
    return {**zero_launches(), "sop": sops, "plan_exec": adds + windows * c,
            "sop_fr": 1, "fold_planned": folds, "pow_fixed": 1,
            "plan_exec_by_plan": {f"{group}_add_plan": adds,
                                  f"{group}_double_plan": windows * c}}


def expected_msm_large_launches(n: int, c: int, chunk_log2: int = 21):
    """Kernel launches of one msm_g1_large over n >= 16 points with window
    c: msm_g1's schedule (`expected_msm_launches`) per chunk of
    2^chunk_log2 points, the last one as long as what is left, and one
    g1_add at one lane per chunk after the first (the fold)."""
    cs = 1 << chunk_log2
    parts = [expected_msm_launches("g1", min(cs, n - i), c)
             for i in range(0, n, cs)]
    out = {k: sum(p[k] for p in parts) for k in parts[0]
           if k != "plan_exec_by_plan"}
    by_plan = collections.Counter()
    for p in parts:
        by_plan.update(p["plan_exec_by_plan"])
    out["plan_exec"] += len(parts) - 1
    by_plan["g1_add_plan"] += len(parts) - 1
    out["plan_exec_by_plan"] = dict(by_plan)
    return out


def msm_host_sum(sc, skip) -> int:
    """sum_i k_i (i+1) mod q over the lanes where `skip` (numpy bool [N])
    is false, for Montgomery Fr scalars sc [16, N] on any device, without a
    Python int per lane: the Montgomery values are linear in the canonical
    ones, so S = sum_k 2^(16 k) sum_i limb_k[i] w_i (w_i = i + 1, 0 where
    skipped) as numpy uint64 dot products over blocks of MSM_HOST_BLOCK
    lanes (each below 2^16 2^25 2^20 = 2^61 up to N = 2^24), summed as
    Python ints, then S R^-1 mod q."""
    import numpy as np

    from bls12_381_torch import params

    lim = sc.cpu().numpy()
    n = lim.shape[-1]
    if n > 1 << 24 or lim.min() < 0 or lim.max() >= 1 << 16:
        fail("msm_host_sum: expected 16-bit limbs over at most 2^24 lanes")
    total = 0
    for b0 in range(0, n, MSM_HOST_BLOCK):
        b1 = min(n, b0 + MSM_HOST_BLOCK)
        w = np.arange(b0 + 1, b1 + 1, dtype=np.uint64)
        w[skip[b0:b1]] = 0
        for k in range(lim.shape[0]):
            total += int(np.dot(lim[k, b0:b1].astype(np.uint64), w)) \
                << (16 * k)
    return total * pow(1 << 256, -1, params.Q) % params.Q


def affine_ints(group: str, point):
    """A projective point with an empty batch shape -> host affine ints
    (None for the identity), through the port's to_affine."""
    from bls12_381_torch.utils import scans

    return affine_lanes(group, scans.tree_map(lambda t: t.unsqueeze(-1),
                                              point), [0])[0]


def phase_msm(device):
    """msm_g1 at 2^16 points and msm_g2 at 2^12 from `entry.msm_entry`:
    launch counts against the static schedule, the host's expected point,
    the 2^10 card = CPU and split / no-split checks, host-clock times (before
    any profiler session) and the MSM's own peak memory."""
    import torch

    from bls12_381_torch import entry, hostmath as hm, params
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.ops import msm
    from bls12_381_torch.utils import scans

    q = params.Q
    r_inv = pow(1 << 256, -1, q)
    out = {}
    for group in ("g1", "g2"):
        mod = {"g1": g1, "g2": g2}[group]
        gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
        mul = {"g1": hm.g1_mul, "g2": hm.g2_mul}[group]
        n = 1 << MSM_LOG_N[group]
        t0 = time.perf_counter()
        fn, (pts, sc) = entry.msm_entry(MSM_LOG_N[group], group, seed=SEED,
                                        device=device)
        torch.cuda.synchronize()
        inputs_s = time.perf_counter() - t0

        # the slice's path, counted
        counts, first_s, peak, held, res = counted_call(
            lambda: fn(pts, sc))
        want = expected_msm_launches(group, n, msm.MSM_WINDOW)
        say("msm", group=group, n=n, c=msm.MSM_WINDOW,
            inputs_seconds=inputs_s, first_msm_seconds=first_s,
            launches=counts, expected=want, msm_peak_bytes=peak,
            held_bytes=held)
        if counts != want:
            fail(f"msm_{group} launch counts {counts} differ from the "
                 f"schedule {want}")

        # the affine result against [sum_i k_i (i+1) mod q]G on the host
        t0 = time.perf_counter()
        inf = mod.is_identity(pts).cpu().tolist()
        ks = [m * r_inv % q for m in limb_ints(sc)]
        total = sum(k * (i + 1) for i, (k, o) in enumerate(zip(ks, inf))
                    if not o) % q
        if affine_ints(group, res) != mul(gen, total):
            fail(f"msm_{group} at 2^{MSM_LOG_N[group]} differs from the "
                 "host's [sum k_i (i+1)]G")
        n_zero = sum(k == 0 for k in ks)
        if not (any(inf) and n_zero):
            fail("the MSM inputs hold no identity lane or no zero scalar")

        # 2^10: the card equals the CPU path in projective coordinates;
        # the split and the plain 255-bit digits agree
        fn_s, (pts_s, sc_s) = entry.msm_entry(MSM_CHECK_LOG_N, group,
                                              seed=SEED + 1, device=device)
        card = fn_s(pts_s, sc_s)
        torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
        t1 = time.perf_counter()
        cpu_res = fn_s(scans.tree_map(lambda t: t.cpu(), pts_s), sc_s.cpu())
        cpu_s = time.perf_counter() - t1
        torch.set_num_threads(1)
        if not same_tree(card, cpu_res):
            fail(f"msm_{group} at 2^{MSM_CHECK_LOG_N}: the card differs "
                 "from the CPU path")
        if not bool(mod.eq(card, fn_s(pts_s, sc_s, msm.MSM_WINDOW, False))):
            fail(f"msm_{group} at 2^{MSM_CHECK_LOG_N}: the split and the "
                 "plain digits disagree")
        say("msm", group=group, checks="passed", identity_lanes=sum(inf),
            zero_scalars=n_zero, cpu_path_seconds=cpu_s,
            host_check_seconds=time.perf_counter() - t0)

        # host clock around synchronized work, after the warm-up run above
        wall, cpu = host_times(lambda: fn(pts, sc), reps=MSM_REPS)
        med = statistics.median(wall)
        say("msm", group=group, seconds=wall, median_seconds=med,
            points_per_s=n / med, host_cpu_share=sum(cpu) / sum(wall))
        out[group] = (counts, med, fn, pts, sc)
    return out


def phase_msm_large(device):
    """bench.py:553-599's G1 rows through `entry.msm_entry` (msm_g1_large)
    at window MSM_LARGE_C: at 2^20 points a counted call against
    `expected_msm_launches` (one chunk), the host's [sum k_i (i+1) mod q]G
    (`msm_host_sum`), the same point at window MSM_LARGE_OTHER_C; at 2^24
    the inputs' seconds and own peak, a counted call per chunk size of
    MSM_LARGE_CHUNKS against `expected_msm_large_launches` with its own
    peak, the host's point, one affine point over the three, and at
    2^MSM_LARGE_EQ_LOG_N msm_g1_large = one msm_g1 pipeline; then
    host-clock medians (MSM_LARGE_REPS) after the counted calls.  No
    failure is caught.  The 2^24 tensors are freed before the return.
    Returns {"2^20": (counts, median, fn, (points, scalars)),
    "2^24": counts of the default chunk's call}."""
    import numpy as np
    import torch

    from bls12_381_torch import entry, hostmath as hm, params
    from bls12_381_torch.curves import g1
    from bls12_381_torch.ops import msm

    c = MSM_LARGE_C
    out = {}
    for log_n in MSM_LARGE_LOG_NS:
        n = 1 << log_n
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fn, (pts, sc) = entry.msm_entry(log_n, "g1", seed=SEED,
                                        device=device)
        torch.cuda.synchronize()
        inputs_s = time.perf_counter() - t0
        inputs_peak = torch.cuda.max_memory_allocated() - held0
        if fn is not msm.msm_g1_large:
            fail("entry.msm_entry(..., 'g1') is not msm_g1_large")

        # the inputs: identity exactly at the lanes i % 64 == 5, zero
        # scalars at i % 64 == 9
        lane = np.arange(n) % entry.MSM_LANE_CYCLE
        skip = lane == entry.MSM_IDENTITY_LANE
        if not np.array_equal(g1.is_identity(pts).cpu().numpy(), skip):
            fail(f"msm_inputs at 2^{log_n}: the identity lanes are not "
                 "i % 64 == 5")
        zero = (sc == 0).all(0).cpu().numpy()
        if not zero[lane == entry.MSM_ZERO_LANE].all():
            fail(f"msm_inputs at 2^{log_n}: a scalar at i % 64 == 9 is "
                 "not 0")
        t1 = time.perf_counter()
        want_pt = hm.g1_mul(params.G1_GEN, msm_host_sum(sc, skip))
        host_s = time.perf_counter() - t1
        say("msm_large", n=n, c=c, inputs_seconds=inputs_s,
            inputs_peak_bytes=inputs_peak,
            inputs_bytes=torch.cuda.memory_allocated() - held0,
            host_oracle_seconds=host_s, identity_lanes=int(skip.sum()),
            zero_scalars=int(zero.sum()))

        # the slice's path, counted, at each chunk size (one at 2^20)
        chunks = MSM_LARGE_CHUNKS if log_n > MSM_LARGE_CHUNKS[0] \
            else MSM_LARGE_CHUNKS[:1]
        points = {}
        for chunk in chunks:
            counts, first_s, peak, held, res = counted_call(
                lambda: fn(pts, sc, c, chunk_log2=chunk))
            want = expected_msm_large_launches(n, c, chunk)
            say("msm_large", n=n, c=c, chunk_log2=chunk,
                first_seconds=first_s, launches=counts, expected=want,
                peak_bytes=peak, held_bytes=held)
            if counts != want:
                fail(f"msm_g1_large at 2^{log_n}, chunk 2^{chunk}: launch "
                     f"counts {counts} differ from the schedule {want}")
            points[chunk] = affine_ints("g1", res)
            if chunk == chunks[0]:
                first = (counts, peak, held)
            del res
        if points[chunks[0]] != want_pt:
            fail(f"msm_g1_large at 2^{log_n} differs from the host's "
                 "[sum k_i (i+1)]G")
        if len(set(points.values())) != 1:
            fail(f"msm_g1_large at 2^{log_n}: the chunk sizes {chunks} give "
                 "different points")

        checks = {}
        if log_n == MSM_LARGE_LOG_NS[0]:
            # another window: other digits, the same point
            other = affine_ints("g1", fn(pts, sc, MSM_LARGE_OTHER_C))
            if other != want_pt:
                fail(f"msm_g1_large at 2^{log_n}: window "
                     f"{MSM_LARGE_OTHER_C} differs from window {c}")
            checks["other_window"] = MSM_LARGE_OTHER_C
        else:
            # chunked = one pipeline, on the first 2^MSM_LARGE_EQ_LOG_N
            m = 1 << MSM_LARGE_EQ_LOG_N
            part = (tuple(t[..., :m] for t in pts), sc[..., :m])
            eq = {}
            for name, call in (
                    ("msm_g1_large", lambda: msm.msm_g1_large(*part, c)),
                    ("msm_g1", lambda: msm.msm_g1(*part, c))):
                _, s_, peak, _, res = counted_call(call)
                eq[name] = (affine_ints("g1", res), s_, peak)
                del res
            if eq["msm_g1_large"][0] != eq["msm_g1"][0]:
                fail(f"at 2^{MSM_LARGE_EQ_LOG_N} points msm_g1_large "
                     "differs from msm_g1")
            checks["eq_log_n"] = MSM_LARGE_EQ_LOG_N
            checks["eq_seconds_peak"] = {k: v[1:] for k, v in eq.items()}
            del part

        # host clock around synchronized work, after the counted calls
        wall, cpu = host_times(lambda: fn(pts, sc, c),
                               reps=MSM_LARGE_REPS[log_n])
        med = statistics.median(wall)
        counts, peak, held = first
        say("msm_large", n=n, c=c, checks="passed", **checks,
            chunk_log2=chunks[0], seconds=wall, median_seconds=med,
            points_per_s=n / med, host_cpu_share=sum(cpu) / sum(wall),
            peak_bytes=peak, held_bytes=held)
        if log_n == MSM_LARGE_LOG_NS[0]:
            out[f"2^{log_n}"] = (counts, med, fn, (pts, sc))
        else:
            out[f"2^{log_n}"] = counts
            del pts, sc
            gc.collect()
            torch.cuda.empty_cache()
    return out


def expected_smul_launches(group: str, name: str, n: int) -> dict:
    """Kernel launches of one call of a phase smul row over n >= 16 lanes,
    from the static schedules of curves/, pairing/gt.py and limbs.py:
      - scalar_mul: from_mont of the scalars (one sop_fr); tables of
        identity, P, ..., 8P per point (7 adds; Gt: 16 entries, 14
        products), then per 4-bit digit step 4 doublings (Gt: one
        fp12_cyclotomic_sqr_k(4)) and one add per point: G1 two points
        over 33 steps, beta x (one sop); G2 four over 17, three psi (one
        fold each); Gt four over 16, three Frobenius maps (three folds
        each);
      - mul_by_const(k): a doubling per bit of k, an add per set bit;
        is_torsion_free: G1 two [|z|] chains, beta x, the fold of eq; G2
        one chain, psi, the fold of eq; clear_cofactor: G1 [h_eff], G2
        three chains, five adds, a doubling, three psi;
      - batch_normalize: the z inversions (`batch_inv`: two product scans
        of 2 lg n products, one pow_fixed, two products; G2 first the norm,
        one sop) and the x, y products (one fold; G2 one more for
        fp2_batch_inv's two products)."""
    from bls12_381_torch import params

    def lg(m):
        return (m - 1).bit_length()

    x = params.BLS_X
    out = zero_launches()
    plans = {}

    def plan(what, k):
        key = {"add": f"{group}_add_plan", "double": f"{group}_double_plan",
               "mul": "fp12_mul_plan",
               "sqr4": "fp12_cyclotomic_sqr_k_plan(4)"}[what]
        plans[key] = plans.get(key, 0) + k

    def mul_by_const(k):
        plan("double", k.bit_length())
        plan("add", bin(k).count("1"))

    if name == "scalar_mul":
        out["sop_fr"] = 1
        if group == "gt":
            steps = 64 // 4
            out["fold_planned"] = 3 * 3
            plan("mul", 4 * 14 + 4 * steps)
            plan("sqr4", steps)
        else:
            points, bits = {"g1": (2, 128), "g2": (4, 64)}[group]
            steps = -(-(bits + 1) // 4)
            out["sop" if group == "g1" else "fold_planned"] = \
                1 if group == "g1" else 3
            plan("add", points * 7 + points * steps)
            plan("double", 4 * steps)
    elif name == "is_torsion_free":
        for _ in range({"g1": 2, "g2": 1}[group]):
            mul_by_const(x)
        if group == "g1":
            out["sop"], out["fold_planned"] = 1, 1
        else:
            out["fold_planned"] = 2
    elif name == "clear_cofactor":
        if group == "g1":
            mul_by_const(params.H_EFF_G1)
        else:
            for _ in range(3):
                mul_by_const(x)
            plan("add", 5)
            plan("double", 1)
            out["fold_planned"] = 3
    elif name == "batch_normalize":
        out["sop"] = 4 * lg(n) + 2 + (group == "g2")
        out["pow_fixed"] = 1
        out["fold_planned"] = {"g1": 1, "g2": 2}[group]
    else:
        raise ValueError(f"no schedule for {group}.{name}")
    out["plan_exec"] = sum(plans.values())
    out["plan_exec_by_plan"] = plans
    return out


def smul_label(group: str, name: str, n: int) -> str:
    return f"{group}_{name}_{n}"


def smul_args(group: str, name: str, n: int, device, outs: dict):
    """The inputs of a phase smul row: scalar_mul's from entry.smul_inputs;
    the subgroup rows' the scalar_mul output at n lanes (outs[(group,
    "scalar_mul", n)], made untimed where no row made it) with the lanes
    i % 64 == BAD_LANE outside the subgroup, cached in outs;
    batch_normalize's from normalize_inputs."""
    from bls12_381_torch import entry
    from bls12_381_torch.curves import g1, g2

    if name == "scalar_mul":
        return entry.smul_inputs(n.bit_length() - 1, group, seed=SEED,
                                 device=device)
    if name == "batch_normalize":
        return (normalize_inputs(group, n, device),)
    key = (group, "subgroup", n)
    if key not in outs:
        prev = outs.get((group, "scalar_mul", n))
        if prev is None:
            prev = {"g1": g1, "g2": g2}[group].scalar_mul(*entry.smul_inputs(
                n.bit_length() - 1, group, seed=SEED, device=device))
        outs[key] = with_bad_lanes(group, prev, device)
    return (outs[key],)


def row_route(call) -> str:
    """The counter a recorded `sop_rows` call adds to: sop (Fp, one
    group), fold_planned (Fp, G >= 2) or sop_fr (Fr)."""
    if call[0].n_limbs == 16:
        return "sop_fr"
    return "fold_planned" if len(call[4]) > 1 else "sop"


def smul_rows_key(route: str, label: str) -> str:
    return f"{route} calls of one {label}"


def normalize_inputs(group: str, n: int, device):
    """Projective P_i = [i+1]G over n lanes (a scan of the group law; z is
    not one), the lanes i % 64 == 5 the identity, as entry.msm_inputs makes
    them for a power of two."""
    import torch

    from bls12_381_torch import entry
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.utils import scans

    mod = {"g1": g1, "g2": g2}[group]
    pts = scans.inclusive_scan(mod.add, mod.generator((n,), device),
                               mod.identity((1,), device))
    lane = torch.arange(n, device=device) % entry.MSM_LANE_CYCLE
    return scans.tree_map(
        lambda i, p: torch.where(lane == entry.MSM_IDENTITY_LANE, i, p),
        mod.identity((n,), device), pts)


def with_bad_lanes(group: str, pts, device):
    """pts with the lanes i % 64 == BAD_LANE replaced by the host's point
    outside the subgroup (hostmath.g1/g2_point_outside_subgroup)."""
    import torch

    from bls12_381_torch import hostmath as hm
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.fields import fp, tower as tw
    from bls12_381_torch.utils import scans

    n = scans.tree_leaves(pts)[0].shape[-1]
    if group == "g1":
        x, y = hm.g1_point_outside_subgroup()
        bad = g1.from_affine((fp.const(x, (n,), device),
                              fp.const(y, (n,), device),
                              torch.zeros(n, dtype=torch.bool,
                                          device=device)))
    else:
        x, y = hm.g2_point_outside_subgroup()
        bad = g2.from_affine((tw.fp2_const(x, (n,), device),
                              tw.fp2_const(y, (n,), device),
                              torch.zeros(n, dtype=torch.bool,
                                          device=device)))
    mask = torch.arange(n, device=device) % 64 == BAD_LANE
    return scans.tree_map(lambda b, p: torch.where(mask, b, p), bad, pts)


def affine_to_host(group: str, aff):
    """Host affine ints (None for the identity) of an affine batch."""
    from bls12_381_torch.fields import fp, tower as tw

    x, y, inf = aff
    if group == "g1":
        xy = ((int(a), int(b)) for a, b in zip(fp.to_ints(x), fp.to_ints(y)))
    else:
        (x0, x1), (y0, y1) = tw.fp2_to_ints(x), tw.fp2_to_ints(y)
        xy = (((int(a), int(b)), (int(c), int(d)))
              for a, b, c, d in zip(x0, x1, y0, y1))
    return [None if i else v for v, i in zip(xy, inf.tolist())]


def pick_lanes(t, lanes):
    """A nested tuple of tensors at some lanes of its last axis."""
    import torch

    from bls12_381_torch.utils import scans

    idx = torch.tensor(lanes, device=scans.tree_leaves(t)[0].device)
    return scans.tree_map(lambda x: x.index_select(-1, idx), t)


def affine_lanes(group: str, pts, lanes):
    """Host affine ints of a projective batch at some lanes, through the
    port's to_affine on the device."""
    from bls12_381_torch.curves import g1, g2

    return affine_to_host(group, {"g1": g1, "g2": g2}[group].to_affine(
        pick_lanes(pts, lanes)))


def gt_lanes(f, lanes):
    """Host Fp12 values (nested int tuples) of a Gt batch at some lanes."""
    from bls12_381_torch.fields import tower as tw

    h = tw.fp12_to_host(f)
    return [tuple(tuple((int(c[0][i]), int(c[1][i])) for c in c6)
                  for c6 in h) for i in lanes]


def same_tree(a, b) -> bool:
    """Two nested tuples of tensors hold equal limbs (any devices)."""
    from bls12_381_torch.utils import scans

    return all(x.cpu().equal(y.cpu()) for x, y in
               zip(scans.tree_leaves(a), scans.tree_leaves(b)))


def phase_smul(device):
    """bench.py:350-427's rows through the port's entry points: for each row
    the inputs, one counted call (the warm-up: launch counts against
    `expected_smul_launches`, own peak memory), SMUL_REPS host-clock runs,
    and the row's checks:
      - scalar_mul (inputs `entry.smul_inputs`): equal to
        scalar_mul_generic on every lane (`eq`, projective), 8 lanes
        (an identity lane, a zero scalar) equal the host's [k (i+1)]G or
        e(G1, G2)^k after to_affine;
      - is_torsion_free (the scalar_mul outputs at 2^12, lanes i % 64 ==
        BAD_LANE a point outside the subgroup): true exactly off those
        lanes;
      - clear_cofactor (the same points): torsion-free on every lane and
        equal to the host's [h_eff]P on sample lanes;
      - batch_normalize (`normalize_inputs`): 8 lanes equal [i+1]G;
    and on SMUL_CPU_LANES lanes the card equals the CPU path limb for limb
    (projective coordinates).  Returns per row (counts, median seconds,
    the call)."""
    import torch

    from bls12_381_torch import entry, hostmath as hm, params
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.pairing import gt
    from bls12_381_torch.utils import scans

    q = params.Q
    r_inv = pow(1 << 256, -1, q)
    mods = {"g1": g1, "g2": g2, "gt": gt}
    gens = {"g1": params.G1_GEN, "g2": params.G2_GEN}
    mul = {"g1": hm.g1_mul, "g2": hm.g2_mul}
    clear = {"g1": hm.g1_clear_cofactor, "g2": hm.g2_clear_cofactor}
    outs, rows = {}, {}

    def to_cpu(t):
        return scans.tree_map(lambda x: x.cpu(), t)

    for group, name, n in SMUL_ROWS:
        label = smul_label(group, name, n)
        mod = mods[group]
        fn = getattr(mod, name)
        t0 = time.perf_counter()
        args = smul_args(group, name, n, device, outs)
        torch.cuda.synchronize()
        inputs_s = time.perf_counter() - t0

        # the row's path, counted (the warm-up of the timed runs)
        counts, first_s, peak, held, out = counted_call(
            lambda: fn(*args))
        want = expected_smul_launches(group, name, n)
        say("smul", row=label, n=n, inputs_seconds=inputs_s,
            first_seconds=first_s, launches=counts, expected=want,
            peak_bytes=peak, held_bytes=held)
        if counts != want:
            fail(f"{label}: launch counts {counts} differ from the schedule "
                 f"{want}")
        outs[(group, name, n)] = out

        # checks
        t0 = time.perf_counter()
        check = {}
        cycle = entry.MSM_LANE_CYCLE
        if name == "scalar_mul":
            lanes = [0, 1, entry.MSM_IDENTITY_LANE, entry.MSM_ZERO_LANE,
                     cycle - 1, n // 2 + 3, n - 2, n - 1]
            ks = [m * r_inv % q for m in limb_ints(args[1])]
            generic = mod.scalar_mul_generic(*args)
            if not bool(mod.eq(out, generic).all()):
                fail(f"{label}: the split and scalar_mul_generic differ")
            if group == "gt":
                inf = [False] * n
                g = hm.gt_generator()
                want_h = [hm.fp12_pow(g, ks[i]) for i in lanes]
                got_h = gt_lanes(out, lanes)
            else:
                inf = mod.is_identity(args[0]).cpu().tolist()
                want_h = [None if inf[i] else
                          mul[group](gens[group], ks[i] * (i + 1) % q)
                          for i in lanes]
                got_h = affine_lanes(group, out, lanes)
            if got_h != want_h:
                fail(f"{label}: lanes {lanes} differ from the host oracle")
            check.update(generic_equal=True, host_lanes=lanes,
                         identity_points=sum(inf[i] for i in lanes),
                         zero_scalars=sum(ks[i] == 0 for i in lanes))
        elif name == "is_torsion_free":
            bad = (torch.arange(n) % 64 == BAD_LANE)
            if not torch.equal(out.cpu(), ~bad):
                fail(f"{label}: not exactly false at the lanes outside the "
                     "subgroup")
            check.update(false_lanes=int(bad.sum()))
        elif name == "clear_cofactor":
            if not bool(mod.is_torsion_free(out).all()):
                fail(f"{label}: a cleared point is not torsion-free")
            lanes = [BAD_LANE, 64 + BAD_LANE, 0, n - 1]
            src = affine_lanes(group, args[0], lanes)
            if affine_lanes(group, out, lanes) != [clear[group](p)
                                                   for p in src]:
                fail(f"{label}: lanes {lanes} differ from the host's "
                     "[h_eff]P")
            check.update(torsion_free=True, host_lanes=lanes)
        else:
            lanes = [0, 1, entry.MSM_IDENTITY_LANE, cycle - 1, 5000, n - 1]
            want_h = [None if i % cycle == entry.MSM_IDENTITY_LANE else
                      mul[group](gens[group], i + 1) for i in lanes]
            if affine_to_host(group, pick_lanes(out, lanes)) != want_h:
                fail(f"{label}: lanes {lanes} are not [i+1]G")
            check.update(host_lanes=lanes)
        # the card equals the CPU path on SMUL_CPU_LANES lanes: the first
        # ones (an identity point, a zero scalar), two outside the
        # subgroup, the last two
        lanes = list(range(SMUL_CPU_LANES - 4)) + [BAD_LANE, 64 + BAD_LANE,
                                                   n - 2, n - 1]
        sub = tuple(pick_lanes(a, lanes) for a in args)
        torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
        t1 = time.perf_counter()
        cpu_out = fn(*(to_cpu(a) for a in sub))
        cpu_s = time.perf_counter() - t1
        torch.set_num_threads(1)
        if not same_tree(fn(*sub), cpu_out):
            fail(f"{label}: the card differs from the CPU path at lanes "
                 f"{lanes}")
        say("smul", row=label, checks="passed", cpu_lanes=lanes,
            cpu_path_seconds=cpu_s,
            host_check_seconds=time.perf_counter() - t0, **check)

        # host clock around synchronized work, after the counted warm-up
        wall, cpu = host_times(lambda fn=fn, args=args: fn(*args),
                               reps=SMUL_REPS)
        med = statistics.median(wall)
        say("smul", row=label, seconds=wall, median_seconds=med,
            per_s=n / med, host_cpu_share=sum(cpu) / sum(wall))
        rows[label] = (counts, med, fn, args)
    return rows


def counted_call(fn):
    """One call of a path with the launch counts set to 0 just before it
    and read just after: (counts, wall seconds ending in a synchronize,
    own peak bytes, bytes held before, the call's value)."""
    import torch

    from bls12_381_torch.kernels import LAUNCHES

    LAUNCHES.reset()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = LAUNCHES.snapshot()
    return counts, wall, torch.cuda.max_memory_allocated() - held, held, out


def expected_codec_launches(group: str, form: str, n: int) -> dict:
    """Kernel launches of one call of a codec function of curves/g1.py or
    g2.py (`form` is its name: from_compressed_host, from_uncompressed_host,
    to_compressed_host or to_uncompressed_host) over n lanes; no step
    depends on n.
      - a parse: to_mont of every coordinate it reads (one sop);
        from_compressed: x^2 x (G1 a sqr and a sop, G2 two folds), the
        square root (G1 one pow_fixed and a sqr for its check; G2
        tw.fp2_sqrt: two fp2_pow_fixed and five folds), the sign of y (one
        sop); from_uncompressed: is_on_curve (two folds, and b z^3: G1 a
        sop, G2 a fold); then the subgroup check, is_torsion_free (G1 two
        [|z|] chains, beta x (a sop) and eq's fold; G2 one chain, psi's
        fold and eq's fold);
      - to_compressed: from_mont of x (one sop) and the sign of y (one
        sop); to_uncompressed: from_mont of x and y (one sop)."""
    from bls12_381_torch import params

    out = zero_launches()
    plans = {}
    g1 = group == "g1"
    if form.startswith("to_"):
        out["sop"] = 2 if form == "to_compressed_host" else 1
    else:
        x = params.BLS_X
        chains = 2 if g1 else 1
        plans = {f"{group}_double_plan": chains * x.bit_length(),
                 f"{group}_add_plan": chains * bin(x).count("1")}
        out["sop"] = 1 + int(g1)
        out["fold_planned"] = 1 + int(not g1)
        if form == "from_compressed_host":
            out["sop"] += 1
            if g1:
                out["sqr"], out["pow_fixed"] = 2, 1
                out["sop"] += 1
            else:
                out["fold_planned"] += 2 + 5
                out["fp2_pow_fixed"] = 2
        else:
            out["fold_planned"] += 2 + int(not g1)
            out["sop"] += int(g1)
    out["plan_exec"] = sum(plans.values())
    out["plan_exec_by_plan"] = plans
    return out


def expected_h2c_launches(group: str, kind: str, n: int) -> dict:
    """Kernel launches of one call of hash_to_curve_* (kind "hash") or
    encode_to_curve_* (kind "encode") with device expansion over n >= 16
    lanes:
      - hash_to_field: the message expansion (one xmd_sha256), from_okm,
        one fold (lo R^2 and hi R^3);
      - the map, u0 and u1 as one batch for "hash": the SSWU map (G1: 7
        sqr, 16 sop and 4 pow_fixed for two inversions and two square
        roots; G2: 5 + 14 folds for its squares and products, two fp2_inv
        of a sop, a pow_fixed and a fold each, two fp2_sqrt of two
        fp2_pow_fixed and five folds each, two fp2_sgn0 of a sop each),
        then the isogeny: Horner over the four coefficient lists (one
        product per coefficient but the top one) and four products (G1 sop,
        G2 fold);
      - "hash": one add of the two halves;
      - clear_cofactor, as `expected_smul_launches` counts it."""
    from bls12_381_torch import params

    out = expected_smul_launches(group, "clear_cofactor", n)
    plans = dict(out["plan_exec_by_plan"])
    iso = {"g1": "iso11", "g2": "iso3"}[group]
    products = 4 + sum(len(params.ISO_CONSTS[f"{iso}_{part}"]) - 1
                       for part in ("xnum", "xden", "ynum", "yden"))
    out["fold_planned"] += 1
    out["xmd_sha256"] += 1
    if group == "g1":
        out["sqr"] += 7
        out["sop"] += 16 + products
        out["pow_fixed"] += 4
    else:
        out["fold_planned"] += 5 + 14 + 2 + 2 * 5 + products
        out["sop"] += 2 + 2
        out["pow_fixed"] += 2
        out["fp2_pow_fixed"] += 4
    if kind == "hash":
        plans[f"{group}_add_plan"] += 1
    out["plan_exec"] = sum(plans.values())
    out["plan_exec_by_plan"] = plans
    return out


def codec_host_points(group: str, n: int):
    """The host affine points of `entry.codec_inputs` at n lanes: [i+1]G,
    the identity (None) at the identity lanes, the host's point outside
    the subgroup at the lanes i % 64 == CODEC_BAD_LANE."""
    from bls12_381_torch import entry, hostmath as hm, params

    add = {"g1": hm.g1_add, "g2": hm.g2_add}[group]
    gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
    bad = {"g1": hm.g1_point_outside_subgroup,
           "g2": hm.g2_point_outside_subgroup}[group]()
    out, acc = [], None
    for i in range(n):
        acc = add(acc, gen)
        lane = i % entry.MSM_LANE_CYCLE
        out.append(None if lane == entry.MSM_IDENTITY_LANE else
                   bad if lane == entry.CODEC_BAD_LANE else acc)
    return out


def reject_cases(group: str, form: str):
    """(label, encoding) pairs that a parse must mark invalid (verify skill
    "Probes"): flag bits wrong, an infinity with a nonzero x or the sort bit,
    an x >= p, an x off the curve (compressed) or a point off the curve
    (uncompressed); the host oracle raises on each."""
    from bls12_381_torch import hostmath as hm, params

    P = params.P
    enc = getattr(hm, f"{group}_to_{form}")
    gen = {"g1": params.G1_GEN, "g2": params.G2_GEN}[group]
    good = bytearray(enc(gen))
    width = 48 if group == "g1" else 96
    cases = []

    def case(label, data):
        cases.append((label, bytes(data)))

    flip = bytearray(good)
    flip[0] ^= 0b1000_0000
    case("compression bit wrong", flip)
    inf_x = bytearray(good)
    inf_x[0] |= 0b0100_0000
    case("infinity with a nonzero x", inf_x)
    inf_sort = bytearray(len(good))
    inf_sort[0] = (0b1110_0000 if form == "compressed" else 0b0110_0000)
    case("infinity with the sort bit", inf_sort)
    big = bytearray(good)
    big[:48] = P.to_bytes(48, "big")
    big[0] |= good[0] & 0b1110_0000
    case("x >= p", big)
    if form == "compressed":
        x = 1
        while (hm.fp_sqrt((x ** 3 + params.B_G1) % P) if group == "g1" else
               hm.fp2_sqrt(hm.fp2_add(hm.fp2_mul(hm.fp2_square((x, 0)),
                                                 (x, 0)), params.B_G2))) \
                is not None:
            x += 1
        off = bytearray(hm.fp_to_bytes(x) if group == "g1" else
                        hm.fp2_to_bytes((x, 0)))
        off[0] |= 0b1000_0000
        case("x off the curve", off)
    else:
        off = bytearray(good)
        off[-1] ^= 1
        case("point off the curve", off)
        sort = bytearray(good)
        sort[0] |= 0b0010_0000
        case("sort bit set", sort)
    assert all(len(c) == len(good) and len(good) in (width, 2 * width)
               for _, c in cases)
    return cases


def phase_codec(device):
    """bench.py:429-462's decoding rows at 2^10 through `entry.codec_entry`
    (G1 and G2, compressed with the subgroup check, uncompressed with the
    check) and the four encoders on the decoded points: per row one
    counted call (launches against `expected_codec_launches`, own peak
    memory), the checks, CODEC_REPS host-clock runs.  Checks: the inputs
    equal hostmath's encodings; the valid mask is false exactly at the
    lanes outside the subgroup (all true with the check off); 8 lanes equal
    the host oracle's decoding; CODEC_CPU_LANES lanes on the card equal the
    CPU path; every encoded lane equals hostmath's encoding.  Then the four
    1000-point tests/vectors/*.dat walks decode on the card as one batch
    each and re-encode byte for byte, and every flag-bit reject of
    `reject_cases` is invalid beside valid controls.  Returns per row
    (counts, median seconds, fn, args)."""
    import numpy as np
    import torch

    from bls12_381_torch import entry, hostmath as hm, params
    from bls12_381_torch.curves import g1, g2

    mods = {"g1": g1, "g2": g2}
    gens = {"g1": params.G1_GEN, "g2": params.G2_GEN}
    n = 1 << CODEC_LOG_N
    cycle = entry.MSM_LANE_CYCLE
    bad = np.arange(n) % cycle == entry.CODEC_BAD_LANE
    rows = {}

    def row(label, fn, args, want_counts):
        counts, first_s, peak, held, out = counted_call(lambda: fn(*args))
        say("codec", row=label, n=n, first_seconds=first_s, launches=counts,
            expected=want_counts, peak_bytes=peak, held_bytes=held)
        if counts != want_counts:
            fail(f"{label}: launch counts {counts} differ from the schedule "
                 f"{want_counts}")
        return counts, out

    def timed(label, counts, fn, args, **check):
        wall, cpu = host_times(lambda: fn(*args), reps=CODEC_REPS)
        med = statistics.median(wall)
        say("codec", row=label, checks="passed", seconds=wall,
            median_seconds=med, per_s=n / med,
            host_cpu_share=sum(cpu) / sum(wall), **check)
        rows[label] = (counts, med, fn, args)

    for group in ("g1", "g2"):
        mod = mods[group]
        host = codec_host_points(group, n)
        for form in CODEC_FORMS:
            want = np.frombuffer(b"".join(
                getattr(hm, f"{group}_to_{form}")(p) for p in host),
                np.uint8).reshape(n, -1)
            t0 = time.perf_counter()
            fn, (data,) = entry.codec_entry(CODEC_LOG_N, group, form, device)
            inputs_s = time.perf_counter() - t0
            if not np.array_equal(data, want):
                fail(f"{group} {form}: codec_inputs differ from hostmath's "
                     "encodings")
            name = f"from_{form}_host"
            label = f"{group}_{name}_{n}"
            counts, (aff, valid) = row(label, fn, (data,),
                                       expected_codec_launches(group, name,
                                                               n))
            if not np.array_equal(valid, ~bad):
                fail(f"{label}: the valid mask is not false exactly at the "
                     "lanes outside the subgroup")
            off = {"check_subgroup" if form == "compressed" else "check":
                   False}
            if not fn(data, **off)[1].all():
                fail(f"{label}: a lane is invalid with the check off")
            lanes = [0, 1, entry.MSM_IDENTITY_LANE, entry.CODEC_BAD_LANE,
                     cycle - 1, n // 2, n - 2, n - 1]
            dec = getattr(hm, f"{group}_from_{form}")
            if affine_to_host(group, pick_lanes(aff, lanes)) != [
                    dec(bytes(data[i]), **off) for i in lanes]:
                fail(f"{label}: lanes {lanes} differ from the host oracle")
            cpu_lanes = list(range(CODEC_CPU_LANES - 4)) + [
                entry.CODEC_BAD_LANE, cycle + entry.CODEC_BAD_LANE, n - 2,
                n - 1]
            torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
            t1 = time.perf_counter()
            aff_cpu, valid_cpu = getattr(mod, name)(data[cpu_lanes],
                                                    device="cpu")
            cpu_s = time.perf_counter() - t1
            torch.set_num_threads(1)
            aff_card, valid_card = fn(data[cpu_lanes])
            if not (same_tree(aff_card, aff_cpu)
                    and np.array_equal(valid_card, valid_cpu)):
                fail(f"{label}: the card differs from the CPU path at lanes "
                     f"{cpu_lanes}")
            timed(label, counts, fn, (data,), inputs_seconds=inputs_s,
                  invalid_lanes=int((~valid).sum()), host_lanes=lanes,
                  cpu_lanes=cpu_lanes, cpu_path_seconds=cpu_s)
            # the encoder, on the decoded points
            enc = getattr(mod, f"to_{form}_host")
            elabel = f"{group}_to_{form}_host_{n}"
            counts, out = row(elabel, enc, (aff,), expected_codec_launches(
                group, f"to_{form}_host", n))
            if not np.array_equal(out, want):
                fail(f"{elabel}: an encoding differs from hostmath's")
            timed(elabel, counts, enc, (aff,), hostmath_equal_lanes=n)

    # the 1000-point walks 0, G, ..., 999G: one batch each, with the checks
    for group in ("g1", "g2"):
        for form in CODEC_FORMS:
            mod = mods[group]
            raw = (VECTORS / f"{group}_{form}_valid_test_vectors.dat") \
                .read_bytes()
            data = np.frombuffer(raw, np.uint8).reshape(1000, -1)
            t0 = time.perf_counter()
            aff, valid = getattr(mod, f"from_{form}_host")(data,
                                                           device=device)
            back = getattr(mod, f"to_{form}_host")(aff)
            if not (valid.all() and np.array_equal(back, data)):
                fail(f"{group} {form} walk: {int((~valid).sum())} invalid, "
                     "or a re-encoding differs")
            say("codec", walk=f"{group}_{form}", points=1000,
                seconds=time.perf_counter() - t0, reencoded_equal=True)

    # flag-bit rejects beside valid controls (G, the identity)
    for group in ("g1", "g2"):
        for form in CODEC_FORMS:
            mod = mods[group]
            enc = getattr(hm, f"{group}_to_{form}")
            dec = getattr(hm, f"{group}_from_{form}")
            cases = reject_cases(group, form)
            for label, c in cases:
                try:
                    dec(c)
                except ValueError:
                    continue
                fail(f"{group} {form} reject '{label}': the host oracle "
                     "accepts it")
            controls = [enc(gens[group]), enc(None)]
            data = np.frombuffer(b"".join([c for _, c in cases] + controls),
                                 np.uint8).reshape(len(cases) + 2, -1)
            _, valid = getattr(mod, f"from_{form}_host")(data, device=device)
            if valid[:len(cases)].any() or not valid[len(cases):].all():
                fail(f"{group} {form} rejects: valid mask {valid.tolist()} "
                     f"for {[lb for lb, _ in cases]} + 2 controls")
            say("codec", rejects=f"{group}_{form}",
                cases=[lb for lb, _ in cases], all_invalid=True,
                controls_valid=True)
    return rows


def phase_h2c(device):
    """bench.py:465-490's rows at batch 256 through `entry.h2c_entry`
    (hash_to_curve and encode_to_curve of G1 and G2, device expansion):
    per row one counted call (launches against `expected_h2c_launches`,
    own peak memory), the checks, H2C_REPS host-clock runs in turns with
    the row's device XMD alone (its share of the row); the host
    expander's hash_to_curve_g2 timed beside its row.  Checks: the 20 KATs
    of tests/vectors/h2c_kats.json (one call per message: the device
    expander takes equal-length messages) equal the expected points; the
    device XMD equals hostmath's on every lane; H2C_CPU_LANES lanes on the
    card equal the CPU path; every output is torsion-free.  Returns per row
    (counts, median seconds, fn, args)."""
    import functools

    import torch

    from bls12_381_torch import entry, hostmath as hm
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.hash_to_curve import h2c
    from bls12_381_torch.kernels import sha256

    mods = {"g1": g1, "g2": g2}
    n = 1 << H2C_LOG_N
    msgs = entry.h2c_inputs(H2C_LOG_N)
    t0 = time.perf_counter()
    for length in (128, 256):  # hash_to_curve's G1 and G2 OKM lengths
        okm = sha256.expand_message_xmd_sha256(
            msgs, entry.H2C_DST, length, device).cpu().numpy()
        for i in range(n):
            if bytes(okm[i]) != hm.expand_message_xmd(
                    bytes(msgs[i]), entry.H2C_DST, length):
                fail(f"device XMD ({length} bytes) differs from hostmath's "
                     f"at lane {i}")
    say("h2c", xmd_lanes=n, xmd_equal=True,
        seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    kats = json.loads((VECTORS / "h2c_kats.json").read_text())
    for name, dst in KAT_DSTS.items():
        group = name[:2]
        kind = "hash" if name.endswith("ro") else "encode"
        fn = getattr(h2c, f"{kind}_to_curve_{group}")
        for c in kats[name]:
            out = fn([c["msg"].encode()], dst, expand="device",
                     device=device)
            got = getattr(mods[group], "to_uncompressed_host")(
                mods[group].to_affine(out))
            if bytes(got[0]).hex() != c["expected"]:
                fail(f"h2c KAT {name} {c['msg'][:16]!r} differs")
    say("h2c", kats=sum(len(kats[k]) for k in KAT_DSTS), kats_equal=True,
        seconds=time.perf_counter() - t0)

    rows = {}
    for group, kind in H2C_ROWS:
        mod = mods[group]
        label = f"{kind}_to_curve_{group}_{n}"
        fn, args = entry.h2c_entry(H2C_LOG_N, group, kind, device)
        want = expected_h2c_launches(group, kind, n)
        counts, first_s, peak, held, out = counted_call(lambda: fn(*args))
        say("h2c", row=label, n=n, first_seconds=first_s, launches=counts,
            expected=want, peak_bytes=peak, held_bytes=held)
        if counts != want:
            fail(f"{label}: launch counts {counts} differ from the schedule "
                 f"{want}")
        if not bool(mod.is_torsion_free(out).all()):
            fail(f"{label}: an output is not torsion-free")
        cpu_fn = functools.partial(getattr(h2c, f"{kind}_to_curve_{group}"),
                                   expand="device", device="cpu")
        sub = (args[0][:H2C_CPU_LANES], args[1])
        torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
        t1 = time.perf_counter()
        cpu_out = cpu_fn(*sub)
        cpu_s = time.perf_counter() - t1
        torch.set_num_threads(1)
        if not same_tree(fn(*sub), cpu_out):
            fail(f"{label}: the card differs from the CPU path on "
                 f"{H2C_CPU_LANES} lanes")
        # the row, its device XMD alone (the row's OKM length) and the
        # plain XMD on the card (the route before the kernel), in turns, so
        # that the medians come from the same stretch of the host's time:
        # the XMD's share of the row, and the share the plain XMD would
        # take of the row with it in the kernel's place
        okm_len = (2 if kind == "hash" else 1) * (64 if group == "g1"
                                                   else 128)
        wall, cpu, xmd, plain_xmd = [], [], [], []
        for _ in range(H2C_REPS):
            w, c = host_times(lambda: fn(*args), reps=1)
            x, _ = host_times(
                lambda: sha256.expand_message_xmd_sha256(
                    args[0], args[1], okm_len, device), reps=1)
            px, _ = host_times(
                lambda: sha256.expand_message_xmd_sha256_plain(
                    args[0], args[1], okm_len, device), reps=1)
            wall, cpu, xmd = wall + w, cpu + c, xmd + x
            plain_xmd += px
        med = statistics.median(wall)
        med_xmd, med_plain = (statistics.median(v) for v in (xmd,
                                                             plain_xmd))
        extra = {}
        if (group, kind) == ("g2", "hash"):
            host_msgs = [bytes(m) for m in args[0]]
            host_fn = functools.partial(h2c.hash_to_curve_g2, device=device)
            if not same_tree(host_fn(host_msgs, args[1]), out):
                fail(f"{label}: the host expander's points differ")
            hwall, _ = host_times(lambda: host_fn(host_msgs, args[1]),
                                  reps=H2C_REPS)
            extra = {"host_expander_seconds": hwall,
                     "host_expander_median_seconds":
                         statistics.median(hwall)}
        say("h2c", row=label, checks="passed", torsion_free=True,
            cpu_lanes=H2C_CPU_LANES, cpu_path_seconds=cpu_s, seconds=wall,
            median_seconds=med, per_s=n / med,
            host_cpu_share=sum(cpu) / sum(wall), xmd_seconds=xmd,
            xmd_share=med_xmd / med, plain_xmd_seconds=plain_xmd,
            plain_xmd_share=med_plain / (med - med_xmd + med_plain),
            **extra)
        rows[label] = (counts, med, fn, args)
    return rows


def expected_bls_launches(n: int) -> dict:
    """Kernel launches of phase bls's round trip over n >= 16 lanes, by
    kernel (the pairing's plans are not counted by name): keygen
    (g1.scalar_mul, to_affine), sign (hash_to_curve_g2 with its one
    xmd_sha256, g2.scalar_mul, to_affine), serialize (both compressed
    encoders), parse (both compressed decoders with the subgroup checks),
    verify (hash_to_curve_g2, to_affine, one pairing over 2n lanes)."""
    parts = [expected_smul_launches("g1", "scalar_mul", n),
             expected_smul_launches("g1", "batch_normalize", n),
             expected_h2c_launches("g2", "hash", n),
             expected_smul_launches("g2", "scalar_mul", n),
             expected_smul_launches("g2", "batch_normalize", n),
             expected_codec_launches("g1", "to_compressed_host", n),
             expected_codec_launches("g2", "to_compressed_host", n),
             expected_codec_launches("g1", "from_compressed_host", n),
             expected_codec_launches("g2", "from_compressed_host", n),
             expected_h2c_launches("g2", "hash", n),
             expected_smul_launches("g2", "batch_normalize", n),
             expected_launches()]
    return {k: sum(p[k] for p in parts) for k in parts[-1]}


def phase_bls(device):
    """The BLS signature round trip at 2^BLS_LOG_N lanes, end to end through
    the port's public functions (the proof-of-possession suite, BLS_DST;
    minimal public keys in G1, signatures in G2; 32-byte messages from the
    seed): keygen ([sk]G1, `g1.scalar_mul`), sign (`hash_to_curve_g2`,
    then `g2.scalar_mul`), serialize (48- and 96-byte compressed), parse
    with the subgroup checks, verify e(pk, H(m)) == e(G1, sig) through
    `pairing` and `fp12_eq`.  Every honest lane must verify; the lanes
    i % 64 == BLS_WRONG_MESSAGE (the signature of another message) must
    fail the pairing check, BLS_FLIPPED_BIT (one flipped body bit of the
    signature) the parse or the pairing check, BLS_OUTSIDE_G2 (a point
    outside G2 as the signature) the parse.  Returns (counts, seconds)."""
    import numpy as np
    import torch

    from bls12_381_torch import hostmath as hm, limbs, params
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.fields import tower as tw
    from bls12_381_torch.hash_to_curve import h2c
    from bls12_381_torch.pairing import pairing
    from bls12_381_torch.utils import scans

    n = 1 << BLS_LOG_N
    rng = np.random.default_rng(SEED)
    msgs = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    sks = [int.from_bytes(rng.bytes(32), "little") % (params.Q - 1) + 1
           for _ in range(n)]
    lane = np.arange(n) % 64
    signed = msgs.copy()
    signed[lane == BLS_WRONG_MESSAGE, 0] ^= 0xFF  # another message
    sk = limbs.from_ints(limbs.FR, sks, device=device)
    torch.cuda.synchronize()

    from bls12_381_torch.kernels import LAUNCHES

    LAUNCHES.reset()
    stages = {}
    t_all = t0 = time.perf_counter()

    def stage(name):
        nonlocal t0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stages[name] = t1 - t0
        t0 = t1

    pk = g1.to_affine(g1.scalar_mul(g1.generator((n,), device), sk))
    stage("keygen")
    h_signed = h2c.hash_to_curve_g2(signed, BLS_DST, expand="device",
                                    device=device)
    stage("sign_hash")
    sig = g2.to_affine(g2.scalar_mul(h_signed, sk))
    stage("sign_mul")
    pk_bytes = g1.to_compressed_host(pk)
    sig_bytes = g2.to_compressed_host(sig)
    stage("serialize")
    # the tampered lanes, in the bytes on the wire
    sig_bytes[lane == BLS_FLIPPED_BIT, 60] ^= 0x10
    sig_bytes[lane == BLS_OUTSIDE_G2] = np.frombuffer(
        hm.g2_to_compressed(hm.g2_point_outside_subgroup()), np.uint8)
    pk_aff, pk_ok = g1.from_compressed_host(pk_bytes, device=device)
    sig_aff, sig_ok = g2.from_compressed_host(sig_bytes, device=device)
    stage("parse")
    h_msg = g2.to_affine(h2c.hash_to_curve_g2(msgs, BLS_DST, expand="device",
                                              device=device))
    stage("verify_hash")
    parsed = torch.from_numpy(pk_ok & sig_ok).to(device)
    pk_aff = pk_aff[:2] + (pk_aff[2] | ~parsed,)
    sig_aff = sig_aff[:2] + (sig_aff[2] | ~parsed,)
    ps = scans.tree_map(lambda a, b: torch.cat([a, b], -1), pk_aff,
                        g1.generator_affine((n,), device))
    qs = scans.tree_map(lambda a, b: torch.cat([a, b], -1), h_msg, sig_aff)
    f = pairing(ps, qs)
    equal = tw.fp12_eq(scans.tree_map(lambda t: t[..., :n], f),
                       scans.tree_map(lambda t: t[..., n:], f))
    verified = (parsed & equal).cpu().numpy()
    stage("verify_pairing")
    total = time.perf_counter() - t_all
    counts = LAUNCHES.snapshot()
    want = expected_bls_launches(n)
    if {k: counts[k] for k in want} != want:
        fail(f"bls: launch counts {counts} differ from the schedule {want}")

    honest = ~np.isin(lane, (BLS_WRONG_MESSAGE, BLS_FLIPPED_BIT,
                             BLS_OUTSIDE_G2))
    if not verified[honest].all():
        fail(f"bls: honest lanes {np.flatnonzero(honest & ~verified)} do "
             "not verify")
    if verified[~honest].any():
        fail(f"bls: tampered lanes {np.flatnonzero(~honest & verified)} "
             "verify")
    wrong = lane == BLS_WRONG_MESSAGE
    if not (pk_ok & sig_ok)[wrong].all():
        fail("bls: a signature of another message does not parse")
    if sig_ok[lane == BLS_OUTSIDE_G2].any():
        fail("bls: a signature outside G2 parses")
    flipped = lane == BLS_FLIPPED_BIT
    say("bls", lanes=n, honest_verified=int(honest.sum()),
        wrong_message_rejected_by_pairing=int(wrong.sum()),
        flipped_rejected_by_parse=int((flipped & ~sig_ok).sum()),
        flipped_rejected_by_pairing=int((flipped & sig_ok).sum()),
        outside_g2_rejected_by_parse=int((lane == BLS_OUTSIDE_G2).sum()),
        stage_seconds=stages, total_seconds=total, launches=counts,
        expected=want)
    return counts, total


# ---------------------------------------------------------------------------
# The card's paths against the independent host oracle
# ---------------------------------------------------------------------------


def expected_oracle_launches(check: str, n: int) -> dict:
    """Kernel launches of one device call of phase oracle over n lanes:
      - "h2c_<group>_<kind>": `expected_h2c_launches`;
      - "multi_pairing": the aggregate pairing with its final
        exponentiation on one rank (`expected_parallel_launches`);
      - "psi": one fold (c_x x^p and c_y y^p as one Fp2 product pair);
      - "fr_sqrt": the power a^((t-1)/2), then Fr products and squares
        (each a sop_fr launch): two products for x and a^t, per bit k of
        the 2^32-order discrete log 31 - k squares and a product (and for
        k > 0 one for the root's correction), the root's product, and the
        check's square: 2 + 496 + 32 + 31 + 1 + 1;
      - "fr_inv": one power; "fr_from_bytes" / "fr_to_bytes": one product
        (to or from Montgomery form); "fr_from_bytes_wide": none (the
        reduction runs on the host);
      - "fp_from_bytes": one product (to Montgomery form)."""
    if check.startswith("h2c_"):
        _, group, kind = check.split("_")
        return expected_h2c_launches(group, kind, n)
    if check == "multi_pairing":  # by kernel (its plans not by name)
        return expected_parallel_launches("pairing_agg_fe", n, (1,))
    zero = zero_launches()
    S = 32
    extra = {"psi": {"fold_planned": 1},
             "fr_sqrt": {"pow_fixed_fr": 1,
                         "sop_fr": 2 + S * (S - 1) // 2 + S + (S - 1) + 2},
             "fr_inv": {"pow_fixed_fr": 1},
             "fr_from_bytes": {"sop_fr": 1}, "fr_to_bytes": {"sop_fr": 1},
             "fr_from_bytes_wide": {}, "fp_from_bytes": {"sop": 1}}[check]
    return {**zero, **extra}


def host_multi_pairing(terms):
    """The host oracle's final_exponentiation(multi_miller_loop(terms))."""
    from bls12_381_torch import hostmath as hm

    return hm.final_exponentiation(hm.multi_miller_loop(terms))


def oracle_inputs() -> dict:
    """Phase oracle's inputs from SEED: the G2 hash lanes (0 and the last
    among them), the multi-pairing's host terms ([a]G1, [b]G2 with a G1
    and a G2 identity), the Fr values (0, 1, q - 1, 4 and the non-square 7
    first), the Fr byte rows ending in the non-canonical q, q + 1,
    2^256 - 1, the 64-byte wide rows, the 48-byte Fp rows of the native
    codec (p, p + 1 and 2^381 - 1 first, about a fifth of the rest >= p)
    and a 300-byte DST."""
    import random

    import numpy as np

    from bls12_381_torch import hostmath as hm, params

    P, Q = params.P, params.Q
    rnd = random.Random(SEED)
    n = 1 << H2C_LOG_N
    g2_lanes = sorted({0, n - 1} | set(rnd.sample(range(1, n - 1),
                                                  ORACLE_G2_LANES - 2)))
    terms = [(hm.g1_mul(params.G1_GEN, rnd.randrange(1, Q)),
              hm.g2_mul(params.G2_GEN, rnd.randrange(1, Q)))
             for _ in range(ORACLE_TERMS)]
    terms[1] = (None, terms[1][1])
    terms[4] = (terms[4][0], None)
    n_fr = 1 << ORACLE_FR_LOG_N
    fr_vals = [0, 1, Q - 1, 4, 7] + [rnd.randrange(Q)
                                     for _ in range(n_fr - 5)]
    fr_rows = [v.to_bytes(32, "little") for v in fr_vals[:-3]] + [
        v.to_bytes(32, "little") for v in (Q, Q + 1, (1 << 256) - 1)]
    wide = [bytes(64), b"\xff" * 64, Q.to_bytes(64, "little")] + [
        rnd.randbytes(64) for _ in range(n_fr - 3)]
    n_fp = 1 << ORACLE_CODEC_LOG_N
    fp_vals = [P, P + 1, (1 << 381) - 1, 0, 1, P - 1] + [
        rnd.randrange(P + P // 4) for _ in range(n_fp - 6)]
    fp_rows = np.frombuffer(b"".join(v.to_bytes(48, "big") for v in fp_vals),
                            np.uint8).reshape(n_fp, 48)
    return {"g2_lanes": g2_lanes, "terms": terms, "fr_vals": fr_vals,
            "fr_rows": fr_rows, "wide": wide, "fp_vals": fp_vals,
            "fp_rows": fp_rows, "big_dst": rnd.randbytes(300)}


def phase_oracle(device):
    """The card's paths against the independent host code: `hostmath`'s
    hash to curve, multi-Miller loop, psi and Fr functions (pure Python,
    run in ORACLE_WORKERS spawned processes while the card works), and the
    native host runtime (`utils/native.py`).  Each device call is counted
    against `expected_oracle_launches`; the first mismatch ends the run.
      - hash_to_curve / encode_to_curve of phase h2c's 256 messages (device
        expansion): G1 on every lane, G2 on ORACLE_G2_LANES lanes, affine
        coordinates as integers;
      - final_exponentiation(multi_miller_loop(p, prepare_g2(q))) over
        ORACLE_TERMS terms against the host's;
      - `g2.psi` on 256 of `msm_inputs`' G2 points against `g2_psi`;
      - `fr.sqrt` on 2^ORACLE_FR_LOG_N lanes (roots, and the mask false
        exactly where `fr_sqrt` gives None), `fr.inv` on the non-zero
        lanes, the Fr byte codecs with their rejects;
      - the native Fp codec at 2^ORACLE_CODEC_LOG_N rows against
        `fp.from_bytes_host` on the card (limbs on the canonical rows, and
        the mask) and back to the input bytes; the native XMD at 256 lanes
        x 128 and 256 bytes (and a 300-byte DST) against hostmath's and
        the device XMD; len_in_bytes 8161 raises.
    Host-clock medians of ORACLE_REPS runs: the native, hostmath and
    device XMD at 256 x 256 bytes, the native Fp decoder against a loop of
    hostmath.fp_from_bytes.  Returns each device check's launch counts."""
    import concurrent.futures as cf
    import multiprocessing as mp

    import numpy as np
    import torch

    from bls12_381_torch import entry, hostmath as hm, params
    from bls12_381_torch import pairing as pr
    from bls12_381_torch.curves import g2
    from bls12_381_torch.fields import fp, fr
    from bls12_381_torch.kernels import sha256
    from bls12_381_torch.utils import native

    t_phase = time.perf_counter()
    n = 1 << H2C_LOG_N
    msgs = entry.h2c_inputs(H2C_LOG_N)
    dst = entry.H2C_DST
    inputs = oracle_inputs()
    terms, fr_vals, fr_rows, wide, fp_vals, fp_rows = (inputs[k] for k in (
        "terms", "fr_vals", "fr_rows", "wide", "fp_vals", "fp_rows"))
    lanes = {"g1": list(range(n)), "g2": inputs["g2_lanes"]}
    workers = max(1, min(ORACLE_WORKERS, os.cpu_count() or 1))
    pool = cf.ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"))
    launches, compared = {}, {}

    def counted(check, lanes_n, fn):
        counts, _, _, _, out = counted_call(fn)
        want = expected_oracle_launches(check, lanes_n)
        if {k: counts[k] for k in want} != want:
            fail(f"oracle {check}: launch counts {counts} differ from the "
                 f"schedule {want}")
        launches[check] = counts
        return out

    try:
        # the host side first (the G2 hashes, the longest, at the head of
        # the queue); the card works while it runs
        host = {}
        for group in ("g2", "g1"):
            for kind in ("hash", "encode"):
                fn = getattr(hm, f"{kind}_to_curve_{group}")
                host[f"h2c_{group}_{kind}"] = [
                    pool.submit(fn, bytes(msgs[i]), dst)
                    for i in lanes[group]]
        host["multi_pairing"] = pool.submit(host_multi_pairing, terms)
        host["fr_sqrt"] = pool.map(hm.fr_sqrt, fr_vals, chunksize=128)

        # hash to curve
        device_pts = {}
        for group in ("g1", "g2"):
            for kind in ("hash", "encode"):
                check = f"h2c_{group}_{kind}"
                fn, args = entry.h2c_entry(H2C_LOG_N, group, kind, device)
                out = counted(check, n, lambda: fn(*args))
                device_pts[check] = affine_lanes(group, out, lanes[group])

        # the multi-pairing
        p_aff, q_aff = encode(
            [(0, 0, True) if p is None else (p[0], p[1], False)
             for p, _ in terms],
            [((0, 0), (0, 0), True) if q is None else (q[0], q[1], False)
             for _, q in terms], device)
        f = counted("multi_pairing", ORACLE_TERMS,
                    lambda: pr.final_exponentiation(pr.multi_miller_loop(
                        p_aff, pr.prepare_g2(q_aff))))
        device_gt = fp12_host(f)

        # psi
        psi_lanes = list(range(1 << ORACLE_PSI_LOG_N))
        pts, _ = entry.msm_inputs(ORACLE_PSI_LOG_N, "g2", seed=SEED,
                                  device=device)
        out = counted("psi", len(psi_lanes), lambda: g2.psi(pts))
        psi_dev = affine_lanes("g2", out, psi_lanes)
        psi_host = [hm.g2_psi(pt) for pt in affine_lanes("g2", pts,
                                                         psi_lanes)]
        if psi_dev != psi_host:
            bad = [i for i, (a, b) in enumerate(zip(psi_dev, psi_host))
                   if a != b]
            fail(f"oracle psi: lanes {bad[:8]} differ from g2_psi")
        compared["psi"] = len(psi_lanes)

        # Fr: inversion, the codecs (the square roots are checked below,
        # against the host pool's)
        n_fr = len(fr_vals)
        a = fr.from_ints(fr_vals, device=device)
        root, ok = counted("fr_sqrt", n_fr, lambda: fr.sqrt(a))
        roots_dev, ok_dev = fr.to_ints(root), ok.cpu().tolist()
        nonzero = [v for v in fr_vals if v]
        a_nz = fr.from_ints(nonzero, device=device)
        inv = counted("fr_inv", len(nonzero), lambda: fr.inv(a_nz))
        if list(fr.to_ints(inv)) != [hm.fr_inv(v) for v in nonzero]:
            fail("oracle fr.inv differs from fr_inv")
        compared["fr_inv"] = len(nonzero)
        rows = np.frombuffer(b"".join(fr_rows), np.uint8).reshape(-1, 32)
        m, valid = counted("fr_from_bytes", len(fr_rows),
                           lambda: fr.from_bytes_host(rows, device=device))
        host_fr = [hm.fr_from_bytes(r) for r in fr_rows]
        if valid.tolist() != [v is not None for v in host_fr] \
                or valid[-3:].any():
            fail("oracle fr.from_bytes_host's mask differs from "
                 "fr_from_bytes")
        got = fr.to_ints(m)
        if [int(g) for g, v in zip(got, valid) if v] != [
                v for v in host_fr if v is not None]:
            fail("oracle fr.from_bytes_host differs from fr_from_bytes")
        back = counted("fr_to_bytes", len(fr_rows),
                       lambda: fr.to_bytes_host(m))
        if [bytes(r) for r, v in zip(back, valid) if v] != [
                hm.fr_to_bytes(v) for v in host_fr if v is not None]:
            fail("oracle fr.to_bytes_host differs from fr_to_bytes")
        wrows = np.frombuffer(b"".join(wide), np.uint8).reshape(-1, 64)
        w = counted("fr_from_bytes_wide", len(wide),
                    lambda: fr.from_bytes_wide_host(wrows, device=device))
        if list(fr.to_ints(w)) != [hm.fr_from_bytes_wide(r) for r in wide]:
            fail("oracle fr.from_bytes_wide_host differs from "
                 "fr_from_bytes_wide")
        compared["fr_codecs"] = {"from_bytes": len(fr_rows),
                                 "rejected": 3, "wide": len(wide)}

        # the native runtime: Fp codecs
        t0 = time.perf_counter()
        nat, nat_ok = native.fp_from_bytes(fp_rows)
        build_s = time.perf_counter() - t0
        dev, dev_ok = counted("fp_from_bytes", len(fp_vals),
                              lambda: fp.from_bytes_host(fp_rows,
                                                         device=device))
        if nat_ok.tolist() != dev_ok.tolist() or nat_ok[:3].any() \
                or nat_ok.tolist() != [v < params.P for v in fp_vals]:
            fail("oracle native fp_from_bytes's mask differs")
        dev = dev.cpu().numpy()
        if not np.array_equal(nat[:, nat_ok].astype(np.int64),
                              dev[:, nat_ok].astype(np.int64)) \
                or nat[:, ~nat_ok].any():
            fail("oracle native fp_from_bytes differs from "
                 "fp.from_bytes_host on the card")
        if not np.array_equal(native.fp_to_bytes(nat)[nat_ok],
                              fp_rows[nat_ok]):
            fail("oracle native fp_to_bytes does not give the input bytes")
        compared["native_fp_codec"] = {"rows": len(fp_vals),
                                       "canonical": int(nat_ok.sum())}

        # the native runtime: expand_message_xmd
        big_dst = inputs["big_dst"]
        for d in (dst, big_dst):
            for length in ORACLE_XMD_LENGTHS:
                nat = native.expand_message_xmd_sha256(
                    [bytes(r) for r in msgs], d, length)
                want = [hm.expand_message_xmd(bytes(r), d, length)
                        for r in msgs]
                dev = sha256.expand_message_xmd_sha256(msgs, d, length,
                                                       device).cpu().numpy()
                if [bytes(r) for r in nat] != want or not np.array_equal(
                        nat, dev):
                    fail(f"oracle native XMD ({length} bytes, DST of "
                         f"{len(d)}) differs")
        try:
            native.expand_message_xmd_sha256([b""], dst, 8161)
        except ValueError:
            pass
        else:
            fail("oracle native XMD takes len_in_bytes 8161")
        compared["native_xmd"] = {"lanes": n, "lengths": ORACLE_XMD_LENGTHS,
                                  "dst_bytes": (len(dst), len(big_dst))}

        # the host side's answers
        t0 = time.perf_counter()
        for check, futs in host.items():
            if not check.startswith("h2c_"):
                continue
            group = check.split("_")[1]
            want = [fut.result() for fut in futs]
            got = device_pts[check]
            if got != want:
                bad = [lanes[group][i] for i, (x, y) in
                       enumerate(zip(got, want)) if x != y]
                fail(f"oracle {check}: lanes {bad[:8]} differ from the "
                     "host oracle")
            compared[check] = len(want)
        if device_gt != host["multi_pairing"].result():
            fail("oracle multi-pairing differs from the host's "
                 "final_exponentiation(multi_miller_loop(terms))")
        compared["multi_pairing_terms"] = ORACLE_TERMS
        roots_host = list(host["fr_sqrt"])
        if ok_dev != [r is not None for r in roots_host]:
            fail("oracle fr.sqrt's mask differs from fr_sqrt")
        if [int(r) for r, o in zip(roots_dev, ok_dev) if o] != [
                r for r in roots_host if r is not None]:
            fail("oracle fr.sqrt's roots differ from fr_sqrt's")
        compared["fr_sqrt"] = {"lanes": n_fr, "residues": sum(ok_dev)}
        host_wait = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # host-clock medians
    def median_s(fn):
        return statistics.median(host_times(fn, reps=ORACLE_REPS)[0])

    host_msgs = [bytes(r) for r in msgs]
    length = ORACLE_XMD_LENGTHS[-1]
    timings = {
        "native_xmd_s": median_s(lambda: native.expand_message_xmd_sha256(
            host_msgs, dst, length)),
        "hostmath_xmd_s": median_s(lambda: [
            hm.expand_message_xmd(m, dst, length) for m in host_msgs]),
        "device_xmd_s": median_s(lambda: sha256.expand_message_xmd_sha256(
            msgs, dst, length, device)),
        "native_fp_from_bytes_s": median_s(
            lambda: native.fp_from_bytes(fp_rows)),
        "hostmath_fp_from_bytes_loop_s": median_s(lambda: [
            hm.fp_from_bytes(r.tobytes()) for r in fp_rows]),
    }
    say("oracle", compared=compared, launches=launches,
        xmd_shape=[n, length], fp_rows=len(fp_vals), workers=workers,
        native_first_call_seconds=build_s, host_wait_seconds=host_wait,
        median_seconds=timings, reps=ORACLE_REPS,
        seconds=time.perf_counter() - t_phase)
    return launches


def expected_parallel_launches(kind: str, n: int, mesh_shape: tuple,
                                window: int = PARALLEL_WINDOW) -> dict:
    """Kernel launches of one call of a sharded path on one rank of a mesh
    of `mesh_shape`, from the schedules of parallel/ (n: the global batch,
    points or transform size):
      - pairing: the pairing's schedule on the rank's shard
        (`expected_launches`; the same at any batch);
      - pairing_agg (final_exp=False): prepare_g2 and the Miller loop (68
        plans each, the line scaling's fold), the halving tree product of
        the shard (ceil(lg b) fp12_mul) and of each axis' gathered values
        (ceil(lg size)); pairing_agg_fe adds one final exponentiation;
      - msm_g1 / msm_g2: the local msm of the shard
        (`expected_msm_launches`) and size - 1 adds per axis;
      - ntt / intt: two local NTTs of lengths n1 and n2 (lg N butterflies,
        lg n1 - 1 + lg n2 - 1 twiddle doublings) and the outer twiddle
        product, the inverse's 1/N scaling: `expected_ntt_launches`'s
        counts, with the twiddle table cached (its first call adds 2 lg n2
        `sop_fr` launches).
    `copied_rows` is 0 on every path."""
    import importlib

    def lg(m):
        return (m - 1).bit_length()

    ranks = math.prod(mesh_shape)
    if kind in ("ntt", "intt"):
        return expected_ntt_launches(n, kind == "intt")
    if kind in ("msm_g1", "msm_g2"):
        group = kind[-2:]
        want = expected_msm_launches(group, n // ranks, window)
        adds = sum(size - 1 for size in mesh_shape)
        want["plan_exec"] += adds
        want["plan_exec_by_plan"][f"{group}_add_plan"] += adds
        return want
    pm = importlib.import_module("bls12_381_torch.pairing.pairing")
    whole = expected_launches()
    if kind == "pairing":
        return whole
    tree = lg(n // ranks) + sum(lg(size) for size in mesh_shape)
    want = {**zero_launches(), "plan_exec": 2 * pm.N_COEFFS + tree,
            "fold_planned": 1}
    del want["plan_exec_by_plan"]
    if kind == "pairing_agg_fe":  # the pairing's schedule less its Miller part
        want["plan_exec"] += whole["plan_exec"] - 2 * pm.N_COEFFS
        want["fold_planned"] += whole["fold_planned"] - 1
        want["sop"], want["pow_fixed"] = whole["sop"], whole["pow_fixed"]
    return want


PARALLEL_KINDS = ("pairing_agg_fe", "pairing_agg", "pairing", "msm_g1",
                  "msm_g2", "intt", "ntt")


def parallel_kind(row: str) -> str:
    """The schedule of a phase parallel row: its name up to the size or
    mesh suffix ("ntt_20_2x2" -> "ntt")."""
    return next(k for k in PARALLEL_KINDS
                if row == k or row.startswith(k + "_"))


def digest(tree) -> str:
    """SHA-256 of a nested tuple of tensors (shapes, dtypes and limbs):
    equal digests are equal values."""
    import hashlib

    from bls12_381_torch.utils import scans

    h = hashlib.sha256()
    for t in scans.tree_leaves(tree):
        t = t.detach().cpu().contiguous()
        h.update(f"{tuple(t.shape)} {t.dtype}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def affine_of(mod):
    """A projective point with an empty batch shape -> its affine (x, y,
    inf) over one lane, through the port's to_affine."""
    from bls12_381_torch.utils import scans

    return lambda pt: mod.to_affine(scans.tree_map(
        lambda t: t.unsqueeze(-1), pt))


def as_is(value):
    return value


def parallel_rows(inputs: dict, window: int, world: int):
    """(row, call, post) of phase parallel over the initialised world:
    every sharded path on the 1-D mesh of all ranks, and for a world of
    PARALLEL_RANKS msm_g1 and the NTTs on the 2 x world/2 mesh as well.
    `post` turns a call's value into what is compared (affine points for
    the MSMs).  inputs: "pairing" (p_aff, q_aff), "msm_g1" / "msm_g2"
    (points, scalars), "ntt" {lg N: coefficients}, "ntt_y" {lg N: their
    transform}, the same on every rank."""
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.parallel import (mesh as mesh_mod, msm_g1_sharded,
                                          msm_g2_sharded, ntt_sharded,
                                          pairing_sharded)

    mesh = mesh_mod.make_mesh()
    meshes = [("", mesh)]
    if world == PARALLEL_RANKS:
        meshes.append((f"_2x{world // 2}", mesh_mod.make_mesh_2d(
            2, world // 2)))
    p, q = inputs["pairing"]
    rows = [
        ("pairing", lambda: pairing_sharded(mesh, p, q), as_is),
        ("pairing_agg", lambda: pairing_sharded(
            mesh, p, q, aggregate=True, final_exp=False), as_is),
        ("pairing_agg_fe", lambda: pairing_sharded(
            mesh, p, q, aggregate=True), as_is),
        ("msm_g2", lambda: msm_g2_sharded(mesh, *inputs["msm_g2"], c=window),
         affine_of(g2))]
    for suffix, m in meshes:
        rows.append((f"msm_g1{suffix}", lambda m=m: msm_g1_sharded(
            m, *inputs["msm_g1"], c=window), affine_of(g1)))
        for log_n, x in inputs["ntt"].items():
            y = inputs["ntt_y"][log_n]
            rows += [(f"ntt_{log_n}{suffix}",
                      lambda m=m, x=x: ntt_sharded(m, x), as_is),
                     (f"intt_{log_n}{suffix}",
                      lambda m=m, y=y: ntt_sharded(m, y, inverse=True),
                      as_is)]
    return rows


def parallel_local(inputs: dict, window: int) -> dict:
    """row -> (call, post) of the local (one-device) path that each row of
    `parallel_rows` must equal; the 2-D rows share the 1-D rows'."""
    from bls12_381_torch import pairing as pr
    from bls12_381_torch.curves import g1, g2
    from bls12_381_torch.ops import msm, ntt

    p, q = inputs["pairing"]
    local = {
        "pairing": (lambda: pr.pairing(p, q), as_is),
        "pairing_agg": (lambda: pr.multi_miller_loop(p, pr.prepare_g2(q)),
                        as_is),
        "pairing_agg_fe": (lambda: pr.final_exponentiation(
            pr.multi_miller_loop(p, pr.prepare_g2(q))), as_is),
        "msm_g1": (lambda: msm.msm_g1(*inputs["msm_g1"], c=window),
                   affine_of(g1)),
        "msm_g2": (lambda: msm.msm_g2(*inputs["msm_g2"], c=window),
                   affine_of(g2))}
    for log_n, x in inputs["ntt"].items():
        y = inputs["ntt_y"][log_n]
        local[f"ntt_{log_n}"] = (lambda x=x: ntt.ntt(x), as_is)
        local[f"intt_{log_n}"] = (lambda y=y: ntt.intt(y), as_is)
    return local


def parallel_job(spec: dict, inputs_path: str) -> dict:
    """One rank's part of phase parallel (also run on the CPU by
    tests/test_torch_parallel.py), in an initialised process group: the
    inputs from `inputs_path` on spec["device"], then per row of
    `parallel_rows` an uncounted warm-up call when spec["reps"] timed calls
    follow (it builds the NTT's twiddle table), a call with the launch
    counts set to 0 just before it and read just after (with the row's own
    peak memory on a card), and the spec["reps"] timed calls, each started
    together on every rank (a barrier) and ended in a synchronize; then
    `multichip_entry` once.  Returns row -> {"value": the compared value (its
    `digest` unless spec["values"]), "launches", "first_seconds",
    "seconds", "cpu_seconds", "peak_bytes", "held_bytes"}, "entry" ->
    the entry's (results, inputs) on the CPU, and in a world of
    PARALLEL_RANKS "shards" -> {`shard_label(a)`: the lanes of a batch of
    2 PARALLEL_RANKS that `shard_batch` gives this rank on the 2-D mesh
    with axis_name a, for a in SHARD_AXES}."""
    import torch
    import torch.distributed as dist

    from bls12_381_torch import entry
    from bls12_381_torch.kernels import LAUNCHES
    from bls12_381_torch.parallel import mesh as mesh_mod

    device = torch.device(spec["device"])
    cuda = device.type == "cuda"
    inputs = torch.load(inputs_path, map_location=device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    out = {}
    for row, call, post in parallel_rows(inputs, spec["window"],
                                         dist.get_world_size()):
        if spec["reps"]:
            call()
            sync()
        dist.barrier()
        held = peak = None
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
            held = torch.cuda.memory_allocated(device)
        LAUNCHES.reset()
        t0 = time.perf_counter()
        value = call()
        sync()
        first = time.perf_counter() - t0
        counts = LAUNCHES.snapshot()
        if cuda:
            peak = torch.cuda.max_memory_allocated(device) - held
        wall, cpu = [], []
        for _ in range(spec["reps"]):
            dist.barrier()
            t0, c0 = time.perf_counter(), time.thread_time()
            call()
            cpu.append(time.thread_time() - c0)
            sync()
            wall.append(time.perf_counter() - t0)
        value = post(value)
        out[row] = {"value": to_cpu(value) if spec["values"]
                    else digest(value), "launches": counts,
                    "first_seconds": first, "seconds": wall,
                    "cpu_seconds": cpu, "peak_bytes": peak,
                    "held_bytes": held}
    results, ins = entry.multichip_entry(dist.get_world_size(), device)
    out["entry"] = to_cpu((results, ins))
    if dist.get_world_size() == PARALLEL_RANKS:
        mesh2 = mesh_mod.make_mesh_2d(2, PARALLEL_RANKS // 2)
        lanes = torch.arange(2 * PARALLEL_RANKS, device=device)
        out["shards"] = {shard_label(a): mesh_mod.shard_batch(
            mesh2, lanes, axis_name=a).tolist() for a in SHARD_AXES}
    return out


def shard_label(axis_name) -> str:
    """"all" for axis_name None, else the axis names joined by commas."""
    if axis_name is None:
        return "all"
    return axis_name if isinstance(axis_name, str) else ",".join(axis_name)


def expected_shards(rank: int, world: int) -> dict:
    """The lanes of a batch of 2 world that rank holds on the 2 x world/2
    mesh (ranks host-major) for each axis_name of SHARD_AXES: the batch in
    as many blocks as the named axes have ranks, block index the rank's
    coordinates along them, the first axis major (the JAX package's
    NamedSharding)."""
    coord = dict(zip(("host", "x"), divmod(rank, world // 2)))
    size = {"host": 2, "x": world // 2}
    out = {}
    for a in SHARD_AXES:
        names = ("host", "x") if a is None else (a,) if isinstance(a, str) \
            else a
        n_blocks = math.prod(size[k] for k in names)
        index = 0
        for k in names:
            index = index * size[k] + coord[k]
        b = 2 * world // n_blocks
        out[shard_label(a)] = list(range(index * b, index * b + b))
    return out


def parallel_rank(rank: int, world: int, backend: str, store: str,
                  spec: dict, inputs_path: str, out_dir: str) -> None:
    """A spawned rank: set its device and one host thread, join the
    process group (a file store), run `parallel_job`, save what it
    returns to out_dir/rank{rank}.pt and leave the group."""
    import torch
    import torch.distributed as dist

    if torch.device(spec["device"]).type == "cuda":
        torch.cuda.set_device(torch.device(spec["device"]))
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    out = parallel_job(spec, inputs_path)
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.destroy_process_group()


def spawn_ranks(world: int, backend: str, spec: dict, inputs_path: str,
                tmp: str) -> list:
    """`parallel_job` on `world` spawned ranks (start method spawn: CUDA
    cannot be forked; the kernels must be built already); raises if a rank
    raises or exits nonzero (the others are then ended).  Returns each
    rank's value, in rank order."""
    import torch
    import torch.multiprocessing as mp

    store = str(Path(tmp) / f"store_{backend}_{world}")
    mp.start_processes(parallel_rank, args=(
        world, backend, store, spec, inputs_path, tmp), nprocs=world,
        join=True, start_method="spawn")
    return [torch.load(Path(tmp) / f"rank{r}.pt")
            for r in range(world)]


def to_cpu(obj):
    """Tensors of nested dicts, tuples and lists copied to the CPU."""
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj.cpu()


def fp12_host(f) -> tuple:
    """An Fp12 value with an empty batch shape as host nested int tuples."""
    from bls12_381_torch.fields import tower as tw

    return tuple(tuple((int(c[0]), int(c[1])) for c in c6)
                 for c6 in tw.fp12_to_host(f))


def msm_host(group: str, pts, sc):
    """The host's [sum_i k_i (i+1) mod q]G of `entry.msm_inputs`' points
    (P_i = [i+1]G, identity lanes skipped) and Montgomery scalars."""
    from bls12_381_torch import hostmath as hm, params
    from bls12_381_torch.curves import g1, g2

    mod = {"g1": g1, "g2": g2}[group]
    inf = mod.is_identity(pts).cpu().tolist()
    r_inv = pow(1 << 256, -1, params.Q)
    ks = [k * r_inv % params.Q for k in limb_ints(sc)]
    total = sum(k * (i + 1) for i, (k, o) in enumerate(zip(ks, inf))
                if not o) % params.Q
    return {"g1": hm.g1_mul, "g2": hm.g2_mul}[group](
        {"g1": params.G1_GEN, "g2": params.G2_GEN}[group], total)


def check_parallel(world: int, ranks: list, want: dict) -> None:
    """Every rank of a run holds every row's local value (digests) with the
    schedule's launch counts and an own peak below PEAK_LIMIT_BYTES, and
    in a world of PARALLEL_RANKS the shards of `expected_shards`."""
    rows = set(want) if world == PARALLEL_RANKS else \
        {r for r in want if "_2x" not in r}
    for rank, res in enumerate(ranks):
        if set(res) - set(NOT_ROWS) != rows:
            fail(f"parallel: rank {rank} of {world} ran the rows "
                 f"{sorted(res)}, not {sorted(rows)}")
        if world == PARALLEL_RANKS and \
                res["shards"] != expected_shards(rank, world):
            fail(f"parallel: shard_batch gave rank {rank} of {world} the "
                 f"lanes {res['shards']}, not "
                 f"{expected_shards(rank, world)}")
        for row in sorted(rows):
            got = res[row]
            if got["value"] != want[row]:
                fail(f"parallel: {row} on rank {rank} of {world} differs "
                     "from the local path")
            mesh_shape = (2, world // 2) if "_2x" in row else (world,)
            kind = parallel_kind(row)
            n = (1 << int(row.split("_")[1]) if kind in ("ntt", "intt")
                 else 1 << MSM_LOG_N[kind[4:]] if kind.startswith("msm")
                 else BATCH)
            expected = expected_parallel_launches(kind, n, mesh_shape)
            if any(got["launches"][k] != v for k, v in expected.items()):
                fail(f"parallel: {row} on rank {rank} of {world} launched "
                     f"{got['launches']}, the schedule is {expected}")
            if got["peak_bytes"] >= PEAK_LIMIT_BYTES:
                fail(f"parallel: {row} on rank {rank} of {world} peaked at "
                     f"{got['peak_bytes']} bytes")


def check_multichip_entry(world: int, value, device) -> None:
    """`entry.multichip_entry`'s results against the local paths on its own
    inputs: the MSM (1-D and 2-D) = the host's [sum k_i]G, the NTT = `ntt`,
    the aggregate Miller value = `multi_miller_loop`."""
    from bls12_381_torch import hostmath as hm, params
    from bls12_381_torch import pairing as pr
    from bls12_381_torch.fields import fr
    from bls12_381_torch.ops import ntt
    from bls12_381_torch.utils import scans

    results, ins = value
    k = sum(int(v) for v in fr.to_ints(ins["msm"][1])) % params.Q
    for key in ("msm", "msm_2d") if world % 2 == 0 else ("msm",):
        if affine_ints("g1", results[key]) != hm.g1_mul(params.G1_GEN, k):
            fail(f"multichip_entry({world}): {key} differs from the host")
    if not same_tree(results["ntt"], ntt.ntt(ins["ntt"].to(device))):
        fail(f"multichip_entry({world}): the NTT differs from ntt")
    p, q = scans.tree_map(lambda t: t.to(device), ins["pairing"])
    if fp12_host(results["pairing"]) != fp12_host(
            pr.multi_miller_loop(p, pr.prepare_g2(q))):
        fail(f"multichip_entry({world}): the aggregate Miller value "
             "differs from multi_miller_loop")


def phase_parallel(device):
    """The sharded paths (parallel/) at full width: pairing_sharded at
    batch BATCH on phase main's inputs (element-wise = `pairing`;
    aggregated without the final exponentiation = `multi_miller_loop`;
    with it = the host's e(G1, G2)^(sum a_i b_i)), msm_g1_sharded at 2^16
    and msm_g2_sharded at 2^12 with window PARALLEL_WINDOW on
    `entry.msm_inputs` (affine = the local MSM = the host's
    [sum k_i (i+1)]G), ntt_sharded at 2^NTT_LOG_N (= `ntt`; its inverse of
    ntt(x) = x); on one NCCL rank in this process and on PARALLEL_RANKS
    gloo ranks sharing the card (spawned; msm_g1 and the NTTs also on the
    2 x 2 mesh): every rank's values against the local ones (digests),
    launches against `expected_parallel_launches`, own peak memory < 1 GB,
    host-clock medians of PARALLEL_REPS runs beside the local call's; and
    `entry.multichip_entry` on every rank.  Returns {ranks: rank 0's
    results by row}."""
    import tempfile

    import torch
    import torch.distributed as dist

    from bls12_381_torch import entry, hostmath as hm, params
    from bls12_381_torch.ops import ntt

    t0 = time.perf_counter()
    a_idx, b_idx, p_aff, q_aff = pairing_inputs(device)
    x = entry.ntt_inputs(NTT_LOG_N, seed=SEED, device=device)
    inputs = {"pairing": (p_aff, q_aff), "ntt": {NTT_LOG_N: x},
              "ntt_y": {NTT_LOG_N: ntt.ntt(x)}}
    for group in ("g1", "g2"):
        inputs[f"msm_{group}"] = entry.msm_inputs(
            MSM_LOG_N[group], group, seed=SEED, device=device)
    torch.cuda.synchronize()
    say("parallel", inputs_seconds=time.perf_counter() - t0)

    # the local paths: the values every rank must hold, timed as the rows
    t0 = time.perf_counter()
    want, local_s = {}, {}
    for row, (call, post) in parallel_local(inputs, PARALLEL_WINDOW).items():
        raw = call()
        value = post(raw)
        want[row] = digest(value)
        wall, _ = host_times(call, reps=PARALLEL_REPS)
        local_s[row] = statistics.median(wall)
        if row == "pairing_agg_fe":
            s = sum(a * b for a, b in zip(a_idx, b_idx)) % params.Q
            if fp12_host(value) != hm.fp12_pow(hm.gt_generator(), s):
                fail("parallel: the product of the pairings differs from "
                     "the host's e(G1, G2)^(sum a_i b_i)")
        elif row.startswith("msm_"):
            if affine_ints(row[-2:], raw) != msm_host(row[-2:],
                                                      *inputs[row]):
                fail(f"parallel: the local {row} differs from the host's "
                     "[sum k_i (i+1)]G")
        elif row.startswith("intt_") and not torch.equal(value, x):
            fail("parallel: intt(ntt(x)) != x")
    for row in list(want):
        if row == "msm_g1" or row.split("_")[0] in ("ntt", "intt"):
            want[f"{row}_2x{PARALLEL_RANKS // 2}"] = want[row]
    say("parallel", local_median_seconds=local_s, host_checks="passed",
        seconds=time.perf_counter() - t0)

    spec = {"device": str(device), "window": PARALLEL_WINDOW,
            "reps": PARALLEL_REPS, "values": False}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs_path = str(Path(tmp) / "inputs.pt")
        torch.save(to_cpu(inputs), inputs_path)
        # one rank: NCCL, in this process
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store_1",
                                rank=0, world_size=1)
        runs[1] = [parallel_job(spec, inputs_path)]
        dist.destroy_process_group()
        seconds = {1: time.perf_counter() - t0}
        # PARALLEL_RANKS ranks sharing the card: gloo, spawned
        t0 = time.perf_counter()
        runs[PARALLEL_RANKS] = spawn_ranks(PARALLEL_RANKS, "gloo", spec,
                                           inputs_path, tmp)
        seconds[PARALLEL_RANKS] = time.perf_counter() - t0
    for world, ranks in runs.items():
        check_parallel(world, ranks, want)
        for res in ranks:
            check_multichip_entry(world, res["entry"], device)
        rows = {row: {
            "median_seconds": statistics.median(r["seconds"]),
            "local_median_seconds": local_s[row.split("_2x")[0]],
            "max_rank_median_seconds": max(statistics.median(
                res[row]["seconds"]) for res in ranks),
            "first_seconds": r["first_seconds"], "seconds": r["seconds"],
            "host_cpu_share": sum(r["cpu_seconds"]) / sum(r["seconds"]),
            "peak_bytes": r["peak_bytes"],
            "max_rank_peak_bytes": max(res[row]["peak_bytes"]
                                       for res in ranks),
            "launches": r["launches"]}
            for row, r in ranks[0].items() if row not in NOT_ROWS}
        say("parallel", ranks=world,
            backend="nccl" if world == 1 else "gloo (CUDA tensors, no "
            "host staging)", wall_seconds=seconds[world], rows=rows,
            checks="passed", multichip_entry="passed")
    return {world: ranks[0] for world, ranks in runs.items()}


def phase_profile(label: str, fn, wall_s: float) -> dict:
    """Where one run of a path goes on the card: device time by kernel,
    from the profiler's device-side events only, each port kernel's mean
    device ms per launch, the `CatArrayBatchedCopy` launches (torch.cat /
    stack) and the other copy launches, the rows `sop_rows` copied, and the
    device's busy share: the union of those events' intervals over the
    unprofiled wall time (and over the profiled run's device span)."""
    from bls12_381_torch.kernels import LAUNCHES

    # The capture must hold one event per counted launch of every port
    # kernel, or the shares below would come from a part of the run.  One
    # window of a few microseconds of device work (an encoder row) once came
    # back with no device events at all (cause not found; PERF.md, open
    # questions): a capture that falls short is taken again, up to three
    # times, and the tries are printed.
    sizes = []
    for tries in range(1, 4):
        LAUNCHES.reset()
        evs = device_events(fn)
        sizes.append(len(evs))
        counted = profiled_launches(LAUNCHES.snapshot())
        captured = collections.Counter(
            k for k in map(kernel_of, (ev[0] for ev in evs)) if k)
        if evs and captured == counted:
            break
    else:
        fail(f"the profile of {label} holds {dict(captured)} port kernel "
             f"events ({len(evs)} device events in all) for the launches "
             f"{dict(counted)}")
    copied_rows = LAUNCHES.copied_rows
    by_name = {}
    for name, start, end in evs:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + end - start, n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    busy_ms = busy_us(evs) / 1e3
    span_ms = (max(e[2] for e in evs) - min(e[1] for e in evs)) / 1e3

    def ours(name):
        return kernel_of(name) is not None

    per_launch = {}
    for k in KERNEL_NAMES:
        mine = [(us, n) for us, n, name in rows if kernel_of(name) == k]
        if mine:
            us, n = map(sum, zip(*mine))
            per_launch[k] = {"launches": n, "ms_per_launch": us / n / 1e3}
    def copies(pick):
        mine = [(us, n) for us, n, name in rows if pick(name)]
        return {"launches": sum(n for _, n in mine),
                "ms": sum(us for us, _ in mine) / 1e3}

    say("profile", path=label, tries=tries, device_events_per_try=sizes,
        device_ms=sum(r[0] for r in rows) / 1e3,
        cat_copies=copies(lambda name: "CatArrayBatchedCopy" in name),
        other_copies=copies(lambda name: "copy" in name.lower()
                            and "CatArrayBatchedCopy" not in name),
        copied_rows=copied_rows,
        device_busy_ms=busy_ms, wall_ms=wall_s * 1e3,
        device_busy_share=busy_ms / (wall_s * 1e3),
        profiled_span_ms=span_ms, busy_share_of_span=busy_ms / span_ms,
        port_kernels_ms=sum(r[0] for r in rows if ours(r[2])) / 1e3,
        other_device_ms=sum(r[0] for r in rows if not ours(r[2])) / 1e3,
        port_kernels=per_launch,
        top=[{"ms": us / 1e3, "count": n, "name": name[:90]}
             for us, n, name in rows[:12]])
    return per_launch


def main() -> None:
    t_all = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "bls12_381_torch" / "kernels" / "csrc").is_dir() \
            or not VECTORS.is_dir():
        fail("run from a checkout of the repository (bls12_381_torch/ and "
             "tests/vectors/ next to this script)")
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        say("phase", name=name, seconds=time.perf_counter() - t0)
        return out

    smi_line = phase("device", phase_device)
    usage = phase("build", phase_build)
    results, timed = phase("kernels", phase_kernels, device, usage)
    phase("hashes", phase_hashes, device, usage, results, timed)
    counts, med, (p_aff, q_aff) = phase("main", phase_main, device)
    counts_ntt, med_ntt, x = phase("ntt", phase_ntt, device)
    msms = phase("msm", phase_msm, device)
    larges = phase("msm_large", phase_msm_large, device)
    smuls = phase("smul", phase_smul, device)
    codecs = phase("codec", phase_codec, device)
    h2cs = phase("h2c", phase_h2c, device)
    bls_counts, _ = phase("bls", phase_bls, device)
    oracle_counts = phase("oracle", phase_oracle, device)
    par = phase("parallel", phase_parallel, device)
    phase("kernel_times", phase_kernel_times, results, timed)
    del timed
    phase("fold_routes", phase_fold_routes, device)
    from bls12_381_torch import pairing as pr
    from bls12_381_torch.ops import ntt

    phase("profile", phase_profile, "pairing",
          lambda: pr.pairing(p_aff, q_aff), med["pairing"])
    phase("profile_ntt", phase_profile, "ntt", lambda: ntt.ntt(x),
          med_ntt["ntt"])
    for group, (_, med_msm, fn, pts, sc) in msms.items():
        phase(f"profile_msm_{group}", phase_profile, f"msm_{group}",
              lambda fn=fn, pts=pts, sc=sc: fn(pts, sc), med_msm)
    large_label = f"msm_g1_2^{MSM_LARGE_LOG_NS[0]}"
    large_counts, med_large, fn, args = larges.pop(
        f"2^{MSM_LARGE_LOG_NS[0]}")
    phase(f"profile_{large_label}", phase_profile, large_label,
          lambda: fn(*args, MSM_LARGE_C), med_large)
    for label, (_, med_row, fn, args) in {**smuls, **codecs,
                                          **h2cs}.items():
        phase(f"profile_{label}", phase_profile, label,
              lambda fn=fn, args=args: fn(*args), med_row)

    from bls12_381_torch.kernels import mont, plan_exec as pe

    def smul_launches(counter, plan=None):
        """A kernel's launches in one call of each phase smul, codec and
        h2c row, in the bls round trip, in phase msm_large's rows and in
        phases oracle and parallel."""
        paths = {label: c for label, (c, *_) in {**smuls, **codecs,
                                                  **h2cs}.items()}
        paths["bls_round_trip"] = bls_counts
        # phase msm_large: msm_g1_large at 2^20 and 2^24 (default chunk)
        paths[large_label] = large_counts
        paths[f"msm_g1_large_2^{MSM_LARGE_LOG_NS[1]}"] = larges[
            f"2^{MSM_LARGE_LOG_NS[1]}"]
        # phase oracle: each device call it held to the host oracle
        for check, counts in oracle_counts.items():
            paths[f"oracle_{check}"] = counts
        # phase parallel: rank 0's launches per sharded call, by row and
        # number of ranks
        for world, rows in par.items():
            for row, r in rows.items():
                if row not in NOT_ROWS:
                    paths[f"parallel_{row}_r{world}"] = r["launches"]
        return {f"launches_{label}": (
            c["plan_exec_by_plan"].get(plan, 0) if plan else c[counter])
            for label, c in paths.items()}

    def entry(name, source, replaces, launches, key, **extra):
        r = results[key]
        counter, _, plan = name.partition(":")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "shape": key, "mismatches": r["mismatches"],
                **smul_launches(counter, plan), **extra}

    src = "bls12_381_torch/kernels/csrc/"
    pallas = "bls12_381_tpu/kernels/pallas_mont.py"
    plan_src = "bls12_381_tpu/kernels/plan_exec.py:778"
    msm_counts = {g: m[0] for g, m in msms.items()}

    def beside(prefix, key):
        """Another shape's numbers for a row: ms, bound, plain, errors."""
        r = results[key]
        return {f"{prefix}_shape": key, **{f"{prefix}_{k}": r[k] for k in (
            "ms", "bound_ms", "plain_ms", "mismatches", "max_abs_err")}}

    def smul_beside(route):
        """The row kernel's calls of each phase smul row on one route,
        replayed in phase kernels: their numbers per launch."""
        out = {}
        for group, name, n in SMUL_ROWS:
            label = smul_label(group, name, n)
            if smul_rows_key(route, label) in results:
                out.update(beside(label, smul_rows_key(route, label)))
        return out

    def launch(key):
        """A row-kernel row's launch shape(s), as phase kernels printed."""
        return {k: v for k, v in results[key].items() if k in (
            "lane_tile", "group_slots", "threads_per_group", "blocks",
            "threads", "param_bytes", "registers", "spill_bytes", "shapes")}

    rows_note = ("the row kernel sop_rows_kernel<F> of csrc/montgomery.cuh, "
                 "instantiated here; its launches are sop, fold_planned "
                 "(Fp) and sop_fr (Fr)")
    kernels = [
        # per launch at the pairing's one sop (fp2_inv's norm, replayed with
        # its operands' own strides) and at the products of one msm_g1;
        # launches per pairing and per msm
        entry("sop", src + "mont.cu", f"{pallas}:620", counts["sop"],
              PAIRING_NORM, note=rows_note,
              launches_msm_g1=msm_counts["g1"]["sop"],
              launches_msm_g2=msm_counts["g2"]["sop"], **launch(PAIRING_NORM),
              **beside("msm_g1", MSM_SOPS), **smul_beside("sop"),
              **beside("msm_large", f"sop T=1 B={MSM_LARGE_SOP_WIDTH}"),
              **beside("stacked", f"sop T=2 B={BATCH}")),
        # launches per round trip (the G1 decompression's two; the G1 h2c
        # rows' seven are launches_<row>); ms per launch at 1024 lanes, the
        # wider timed rows beside it
        entry("sqr", src + "mont_sqr.cuh", f"{pallas}:711",
              bls_counts["sqr"], f"sqr G=1 B={BATCH}",
              note="fp.sqr of the G1 decompression and the G1 SSWU map "
                   "(built into csrc/mont.cu)",
              **{k: v for k, v in results[f"sqr G=1 B={BATCH}"].items()
                 if k in ("threads", "lanes_per_thread", "blocks",
                          "param_bytes", "registers", "spill_bytes",
                          "bytes_ms", "ops_ms")},
              **{k: v for B in SQR_TIMED_WIDTHS if B != BATCH
                 for k, v in beside(f"b{B}", f"sqr G=1 B={B}").items()},
              **beside("g3", f"sqr G=3 B={BATCH}")),
        # the JAX chain of sqr_pallas / sop_pallas launches in one launch
        entry("pow_fixed", src + "mont_pow.cuh", f"{pallas}:711",
              counts["pow_fixed"], f"pow_fixed p-2 B={BATCH}",
              launches_msm_g1=msm_counts["g1"]["pow_fixed"],
              launches_msm_g2=msm_counts["g2"]["pow_fixed"],
              note="the JAX chain is bls12_381_tpu/limbs.py:693 (pow_fixed, "
                   "a scan over sqr_pallas and sop_pallas); built into "
                   "csrc/mont.cu, its Fr instance pow_fixed_fr into "
                   "csrc/fr.cu (fr_* beside it)",
              **{k: v for k, v in results[f"pow_fixed p-2 B={BATCH}"].items()
                 if k in ("threads_per_lane", "lanes", "blocks",
                          "shared_bytes", "registers", "spill_bytes",
                          "bytes_ms", "ops_ms")},
              fr_registers=results[f"pow_fixed_fr q-2 B={BATCH}"][
                  "registers"],
              fr_threads_per_lane=results[f"pow_fixed_fr q-2 B={BATCH}"][
                  "threads_per_lane"],
              registers_by_threads_per_lane={
                  k: v for k, v in usage.items() if k.startswith("pow_")},
              **beside("b1", "pow_fixed p-2 B=1"),
              **beside(f"b{POW_WIDE}", f"pow_fixed p-2 B={POW_WIDE}"),
              **beside("p14", f"pow_fixed (p+1)/4 B={BATCH}"),
              **{k: v for B in POW_TIMED_WIDTHS
                 for k, v in beside(f"fr_b{B}",
                                    f"pow_fixed_fr q-2 B={B}").items()}),
        # launches per pairing, ms and bounds per launch at the pairing's
        # own folds; launches per msm beside them
        entry("fold_planned", src + "mont.cu", f"{pallas}:250",
              counts["fold_planned"], PAIRING_FOLDS, note=rows_note,
              launches_msm_g1=msm_counts["g1"]["fold_planned"],
              launches_msm_g2=msm_counts["g2"]["fold_planned"],
              **launch(PAIRING_FOLDS),
              **beside("line_scaling", "sop_rows line scaling, movedim "
                       "views and yp, xp expanded over 68"),
              **smul_beside("fold_planned")),
    ]
    for make_plan in pe.MAIN_PATH_PLANS:
        plan = pe.compile_plan(make_plan())
        kernels.append(entry(
            f"plan_exec:{plan.name}", src + "plan_exec.cu", plan_src,
            counts["plan_exec_by_plan"].get(plan.name, 0),
            f"plan_exec {plan.name} B={BATCH}"))
    # the group-law plans: launches per msm of their group, phase smul's
    # widest launches beside them (and g1_add at msm_g1_large's widths)
    for make_plan, B in msm_plan_shapes()[:4]:
        plan = pe.compile_plan(make_plan())
        wide = {}
        if make_plan is pe.g1_add_plan:
            for w in MSM_LARGE_PLAN_WIDTHS:
                wide.update(beside(f"b{w}", f"plan_exec {plan.name} B={w}"))
        kernels.append(entry(
            f"plan_exec:{plan.name}", src + "plan_exec.cu", plan_src,
            msm_counts[plan.name[:2]]["plan_exec_by_plan"][plan.name],
            f"plan_exec {plan.name} B={B}",
            **beside(f"b{SMUL_PLAN_WIDTH}",
                     f"plan_exec {plan.name} B={SMUL_PLAN_WIDTH}"), **wide))
    # the NTT's kernels: launches per ntt at 2^20; ms, plain ms and bound
    # per launch at the shapes the ntt launches (its twiddle doublings, a
    # stage)
    kernels.append(entry("sop_fr", src + "fr.cu", f"{pallas}:620",
                         counts_ntt["sop_fr"], DOUBLINGS, note=rows_note,
                         **launch(DOUBLINGS), **smul_beside("sop_fr")))
    kernels.append(entry("butterfly", src + "fr.cu", f"{pallas}:414",
                         counts_ntt["butterfly"], f"butterfly B={NTT_N // 2}"))
    # the Fp2 power: launches per round trip (and per codec and h2c row);
    # ms and bound per launch at B = 1024, (p-1)/2, the other timed widths
    # and (p-3)/4 beside it
    fp2_key = "fp2_pow_fixed (p-1)/2 B={}"
    kernels.append(entry(
        "fp2_pow_fixed", src + "fp2_pow.cuh",
        "bls12_381_tpu/fields/tower.py:287", bls_counts["fp2_pow_fixed"],
        fp2_key.format(BATCH),
        note="the JAX fp2_pow is a lax.scan of fp2_sqr / fp2_mul / select "
             f"over sop_pallas ({pallas}:620); one launch here, two threads "
             "per lane (built into csrc/mont.cu)",
        **{k: v for k, v in results[fp2_key.format(BATCH)].items() if k in (
            "lanes", "threads_per_lane", "blocks", "shared_bytes",
            "registers", "spill_bytes", "bytes_ms", "ops_ms")},
        **{k: v for B in FP2_POW_TIMED_WIDTHS if B != BATCH
           for k, v in beside(f"b{B}", fp2_key.format(B)).items()},
        **beside("p34", f"fp2_pow_fixed (p-3)/4 B={BATCH}")))
    # the hash kernels: launches per round trip (and per h2c row); ms,
    # bound and plain ms per launch at hash to curve's 256 lanes, the full
    # card's 2^16 beside them, and one lane's time (the chain)
    hashes_jax = "bls12_381_tpu/kernels/"
    d = len(HASH_DST)
    for name, key, replaces, source in (
            ("xmd_sha256", f"xmd_sha256 msg=32 out=256 dst={d}",
             "sha256_jax.py:113", "sha256.cu"),
            ("sha256", "sha256 msg=32", "sha256_jax.py:96", "sha256.cu"),
            ("shake", f"shake xof128 msg=32 out=256 dst={d}",
             "keccak_jax.py:122", "keccak.cu")):
        small, full = (f"{key} B={B}" for B in HASH_TIMED_WIDTHS)
        kernels.append(entry(
            name, src + source, hashes_jax + replaces,
            bls_counts[name], small,
            note="the JAX version is jnp fused by XLA, not Pallas"
                 + ("; also replaces keccak_jax.py:164 "
                    "(expand_message_xof_shake, one launch with its "
                    "suffix)" if name == "shake" else ""),
            chain_ms=results[f"{key} B=1"]["ms"],
            threads=results[small]["threads"],
            blocks=results[small]["blocks"],
            registers=usage[name][0], spill_bytes=usage[name][1],
            **{k: v for k, v in results[small].items() if k in (
                "load", "store", "param_bytes", "instance_registers",
                "bytes_ms", "ops_ms")},
            **beside(f"b{HASH_TIMED_WIDTHS[1]}", full)))
    say("phase", name="total", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
