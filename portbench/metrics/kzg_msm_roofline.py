"""The least time of a batch's four G1 MSMs on one H100, in % of the
stream time of the program's span `kzg.msm` per traced call; None
untraced or where the program records no such span.

The work is the cell's frozen textbook count (`fp_products`:
`roofline.pippenger_products` at `best_window` for LL and RLP over the
86,016 proofs, RLC over the 672 commitments and RLI over the setup's 64
points), each product a one-term Montgomery product's 32-bit multiplies
(`roofline.sop_imads`), so the share reads the same work however the
program groups or windows the MSMs."""

import roofline
import stages


def read(run):
    ms = stages.ms_per_call(run, "kzg.msm")
    if not ms:
        return None
    least_s = (run.traffic["roofline"]["fp_products"] * roofline.sop_imads(1)
               / roofline.IMAD_PER_S)
    return 100.0 * least_s / (ms * 1e-3)
