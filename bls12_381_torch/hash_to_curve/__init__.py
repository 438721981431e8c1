"""Hash to curve (draft-irtf-cfrg-hash-to-curve-16) for G1 and G2."""

from .h2c import (  # noqa: F401
    encode_to_curve_g1,
    encode_to_curve_g2,
    hash_to_curve_g1,
    hash_to_curve_g2,
    hash_to_field_fp,
    hash_to_field_fp2,
    map_to_curve_g1,
    map_to_curve_g2,
)
