"""The launch schedule `chip_smoke.py` holds phase bls (the BLS
proof-of-possession round trip) to, on the CPU: phase bls's own code at 16
lanes, with each kernel's plain version counted the way its wrapper
counts the kernel's launches on the card (`test_torch_smul.count_launches`);
the phase checks its counts against `chip_smoke.expected_bls_launches`
itself (a mismatch exits), and its verdicts per lane.

Tolerance: none (integer arithmetic) -- counts and verdicts compare
exactly.
"""

import torch

import conftest  # noqa: F401
import chip_smoke
from test_torch_smul import count_launches

torch.set_num_threads(1)


def test_phase_bls_launch_schedule(monkeypatch):
    """16 lanes (lanes 3, 7 and 11 tampered), about 30 s: two G2 hashes
    with one xmd_sha256 launch each, the scalar multiplications, the
    codecs and one pairing of 32 lanes."""
    monkeypatch.setattr(chip_smoke, "BLS_LOG_N", 4)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    counts, (phase_counts, _) = count_launches(chip_smoke.phase_bls, "cpu")
    want = chip_smoke.expected_bls_launches(16)
    assert phase_counts == counts
    assert {k: counts[k] for k in want} == want
    assert want["xmd_sha256"] == 2 and want["sha256"] == want["shake"] == 0


def test_bls_schedule_is_its_parts():
    """The round trip's schedule is the sum of its functions' (two G2
    hashes, three to_affine, two scalar multiplications, four codecs, one
    pairing) and does not depend on the lanes but through the scans."""
    a, b = (chip_smoke.expected_bls_launches(n) for n in (16, 256))
    h2c = chip_smoke.expected_h2c_launches("g2", "hash", 256)
    assert b["xmd_sha256"] == 2 * h2c["xmd_sha256"] == 2
    assert b["fp2_pow_fixed"] == a["fp2_pow_fixed"] == \
        2 * h2c["fp2_pow_fixed"] + 2
    assert set(a) == set(chip_smoke.zero_launches()) - {"plan_exec_by_plan"}
