"""The sharded paths over `torch.distributed` (counterpart of
`bls12_381_tpu/parallel/`): meshes of ranks, the sharded MSM, the
four-step NTT and the sharded pairing.  The caller initialises the process
group; see `mesh.py`."""

from . import mesh  # noqa: F401
from .msm_sharded import msm_g1_sharded, msm_g2_sharded  # noqa: F401
from .ntt_sharded import ntt_sharded  # noqa: F401
from .pairing_sharded import pairing_sharded  # noqa: F401
