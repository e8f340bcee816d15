"""UrsoNet — the paper's own workload (satellite pose estimation,
Table I).  CNN config, not part of the 10-arch LM pool; used by the
pose trainer (``repro_torch.pose``) and ``chip_smoke.py``."""
from repro_torch.models.cnn import UrsoNetConfig

FULL = UrsoNetConfig(name="ursonet", image_hw=(192, 256),
                     widths=(32, 64, 128, 256), blocks_per_stage=2,
                     fc_dim=256)

SMOKE = UrsoNetConfig(name="ursonet-smoke", image_hw=(96, 128),
                      widths=(8, 16), blocks_per_stage=1, fc_dim=32)
