"""BLS12-381 parameters (canonical integers) and the limb configuration.

The port keeps its own copy of the constants it needs; the values are the
standard ones of the curve (zkcrypto/bls12_381 src/fp.rs, src/scalar.rs,
src/lib.rs, src/notes/design.rs).

Field elements cross the port's public functions as 16-bit limbs, limb axis
first, in Montgomery form with R = 2^384 (Fp), the same numeric domain as the
reference and as `bls12_381_tpu`, so values compare as plain arrays.
"""

# Base field modulus p (381 bits)
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Scalar field modulus q (255 bits)
Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter z, stored as |z|; z itself is negative
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

# Curve equations: G1: y^2 = x^3 + 4; G2: y^2 = x^3 + 4(u + 1)
B_G1 = 4
B_G2 = (4, 4)

G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
FP_LIMBS = 24  # 24 * 16 = 384 bits, R = 2^384


def to_limbs(value: int, n_limbs: int) -> list[int]:
    """Split an integer into n little-endian 16-bit limbs."""
    return [(value >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n_limbs)]


def from_limbs(limbs) -> int:
    """Combine little-endian 16-bit limbs into an integer."""
    out = 0
    for i, limb in enumerate(limbs):
        out |= int(limb) << (LIMB_BITS * i)
    return out
