"""Field layers: Fp, the Fp2/Fp6/Fp12 tower (nested tuples of Fp tensors)
and the scalar field Fr."""

from . import fp, fr, tower  # noqa: F401
