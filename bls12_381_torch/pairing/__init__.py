from . import gt  # noqa: F401
from .pairing import (  # noqa: F401
    G2Prepared,
    final_exponentiation,
    miller_loop_batched,
    multi_miller_loop,
    pairing,
    pairing_batched,
    prepare_g2,
)
