"""FastAggregateVerify of the BLS proof-of-possession ciphersuite on
Python integers.

ethereum/consensus-specs `bls.FastAggregateVerify`, that is the IETF BLS
signature draft's FastAggregateVerify: each public key decoded
(pubkey_to_point: the encoding and the curve, no subgroup check, since a
client's keys passed KeyValidate when they were registered), the keys
summed, then CoreVerify of the sum: the signature a compressed G2 point
in the subgroup, KeyValidate of the aggregate (not the identity, in the
subgroup), and e(sum pk, H(m)) = e(G1, sig), checked as one product of
two Miller loops and one final exponentiation.  An empty set is invalid.
"""

from __future__ import annotations

from . import hostmath as hm
from .bls import DST
from .params import G1_GEN


def fast_aggregate_verify(pks, msg: bytes, sig: bytes,
                          dst: bytes = DST) -> bool:
    if not pks:
        return False
    try:
        points = [hm.g1_from_compressed(pk, check_subgroup=False)
                  for pk in pks]
        sig_pt = hm.g2_from_compressed(sig)
    except ValueError:
        return False
    total = None
    for pt in points:
        total = hm.g1_add(total, pt)
    if total is None or not hm.g1_is_torsion_free(total):
        return False
    h = hm.hash_to_curve_g2(msg, dst)
    f = hm.multi_miller_loop([(total, h), (hm.g1_neg(G1_GEN), sig_pt)])
    return hm.final_exponentiation(f) == hm.FP12_ONE
