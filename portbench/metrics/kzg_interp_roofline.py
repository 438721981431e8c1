"""The least time of a batch's interpolation on one H100, in % of the
stream time of the program's span `kzg.interp` per traced call; None
untraced or where the program records no such span.

The work is the cell's frozen textbook count (`fr_products`: per cell a
64-point inverse NTT's 192 products, the shift's 64 and the weight's 64),
each product a one-term Montgomery product over Fr's 8 words
(`roofline.sop_imads(1, 8)`), so the share reads the same work whatever
transform or sums the program uses."""

import roofline
import stages


def read(run):
    ms = stages.ms_per_call(run, "kzg.interp")
    if not ms:
        return None
    least_s = (run.traffic["roofline"]["fr_products"]
               * roofline.sop_imads(1, 8) / roofline.IMAD_PER_S)
    return 100.0 * least_s / (ms * 1e-3)
