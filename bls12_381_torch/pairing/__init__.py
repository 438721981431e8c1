from .pairing import (  # noqa: F401
    G2Prepared,
    final_exponentiation,
    miller_loop_batched,
    multi_miller_loop,
    pairing,
    prepare_g2,
)
