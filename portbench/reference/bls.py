"""Verify of the BLS proof-of-possession ciphersuite on Python integers.

ethereum/consensus-specs phase0 `bls.Verify`, that is the IETF BLS
signature draft's CoreVerify with KeyValidate: the public key a
compressed G1 point in the subgroup and not the identity, the signature a
compressed G2 point in the subgroup, and e(pk, H(m)) = e(G1, sig), checked
as one product of two Miller loops and one final exponentiation.
"""

from __future__ import annotations

from . import hostmath as hm
from .params import G1_GEN

DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"


def verify(pk: bytes, msg: bytes, sig: bytes, dst: bytes = DST) -> bool:
    try:
        pk_pt = hm.g1_from_compressed(pk)
        sig_pt = hm.g2_from_compressed(sig)
    except ValueError:
        return False
    if pk_pt is None:
        return False
    h = hm.hash_to_curve_g2(msg, dst)
    f = hm.multi_miller_loop([(pk_pt, h), (hm.g1_neg(G1_GEN), sig_pt)])
    return hm.final_exponentiation(f) == hm.FP12_ONE
