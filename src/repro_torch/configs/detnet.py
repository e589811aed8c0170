"""DetNet: the paper's hand-detection workload (Fig 1d).

MobileNetV2 feature extractor + three regression heads (bounding-circle
center, radius, left/right label) on 128x128 egocentric RGB frames.
"""
from repro_torch.configs.base import XRConfig, smoke_xr

CONFIG = XRConfig(
    name="detnet",
    task="detection",
    input_hw=(128, 128),
    in_channels=3,
    num_classes=2,            # left / right hand label
)

SMOKE = smoke_xr(CONFIG)
