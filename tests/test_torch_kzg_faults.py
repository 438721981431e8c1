"""The faults of a cell-proof batch that only the pairing check refuses,
beyond `test_torch_kzg.py`'s wrong evaluation: two cells' proofs
exchanged, a cell's index changed, a cell given its block's other
blob's commitment.  The port's CPU path and the plain reference
(`portbench/reference/kzg.py`) both refuse each, on `test_torch_kzg.py`'s
seeded case; `kernels.CELLS` counts a refusal by the pairing.  A file of
its own: each verdict runs two MSMs and a pairing in plain torch, ~20 s.

Tolerance: none (integer arithmetic).
"""

import pytest
import torch

from test_torch_kzg import case, verdict_matches_reference  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("kind", ["swapped_proofs", "wrong_column",
                                  "wrong_commitment"])
def test_a_fault_only_the_pairing_sees_is_refused_by_both(  # noqa: F811
        case, kind):
    counts = verdict_matches_reference(case, kind)
    assert counts["refused_pairing"] == 1 and counts["accepted"] == 0
