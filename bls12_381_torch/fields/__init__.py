"""Field layers: Fp and the Fp2/Fp6/Fp12 tower (nested tuples of Fp
tensors)."""

from . import fp, tower  # noqa: F401
