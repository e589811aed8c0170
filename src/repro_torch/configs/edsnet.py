"""EDSNet: the paper's eye-segmentation workload (Fig 1e).

UNet with a MobileNetV2 backbone, four classes (background / sclera / iris /
pupil) on 384x640 near-IR frames (OpenEDS is 400x640; 384 divides by 32 for
the 5-level encoder).
"""
from repro_torch.configs.base import XRConfig, smoke_xr

CONFIG = XRConfig(
    name="edsnet",
    task="segmentation",
    input_hw=(384, 640),
    in_channels=1,            # near-IR eye camera
    num_classes=4,
    decoder_channels=(256, 128, 64, 32, 16),
)

SMOKE = smoke_xr(CONFIG, input_hw=(32, 64))
