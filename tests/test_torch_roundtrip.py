"""The BLS proof-of-possession round trip through the port's public
functions (`port_cases.bls_round_trip`: keygen, sign, serialize, parse
with the subgroup checks, verify by pairing), on the CPU at 16 lanes, with
each kernel's plain version counted the way its wrapper counts the
kernel's launches on the card (`test_torch_smul.count_launches`): the
counts equal `port_cases.expected_bls_launches`, which the card test holds
the card to, and every lane's verdict is right.

Tolerance: none (integer arithmetic) -- counts and verdicts compare
exactly.
"""

import torch

import conftest  # noqa: F401
import port_cases
from test_torch_smul import count_launches

torch.set_num_threads(1)


def test_phase_bls_launch_schedule():
    """16 lanes (lanes 3, 7 and 11 tampered), about 30 s: two G2 hashes
    with one xmd_sha256 launch each, the scalar multiplications, the
    codecs and one pairing of 32 lanes."""
    counts, verdicts = count_launches(port_cases.bls_round_trip, 16, "cpu")
    want = port_cases.expected_bls_launches(16)
    assert {k: counts[k] for k in want} == want
    assert want["xmd_sha256"] == 2 and want["sha256"] == want["shake"] == 0
    assert port_cases.round_trip_faults(*verdicts) == []


def test_bls_schedule_is_its_parts():
    """The round trip's schedule is the sum of its functions' (two G2
    hashes, three to_affine, two scalar multiplications, four codecs, one
    pairing) and does not depend on the lanes but through the scans."""
    a, b = (port_cases.expected_bls_launches(n) for n in (16, 256))
    h2c = port_cases.expected_h2c_launches("g2", "hash", 256)
    assert b["xmd_sha256"] == 2 * h2c["xmd_sha256"] == 2
    assert b["fp2_pow_fixed"] == a["fp2_pow_fixed"] == \
        2 * h2c["fp2_pow_fixed"] + 2
    assert set(a) == set(port_cases.zero_launches()) - {"plan_exec_by_plan"}
