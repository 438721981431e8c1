"""The least time of an epoch's key sums on one H100, in % of the stream
time of the program's span `agg` (`KeyRegistry.aggregate`: the indices'
upload and checks, the gather, the segmented sum and the tails) per
traced call; None untraced or where the program records no such span.

The work is the cell's frozen textbook count (`roofline.fp_products`:
one mixed addition of 11 Fp products for each key beyond the first of
its set), each product a one-term Montgomery product's 32-bit multiplies
(`roofline.sop_imads`), so the share reads the same work whatever
formulas or scan the program uses."""

import roofline
import stages


def read(run):
    agg_ms = stages.ms_per_call(run, "agg")
    if not agg_ms:
        return None
    least_s = (run.traffic["roofline"]["fp_products"] * roofline.sop_imads(1)
               / roofline.IMAD_PER_S)
    return 100.0 * least_s / (agg_ms * 1e-3)
