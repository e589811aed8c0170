"""Kernel calibration corners of the compute-plane constants, on the card.

See ``repro_torch.calibrate.harness``. ``write_calibrated`` and ``check`` of
the reference wait for a later slice.
"""
from repro_torch.calibrate.harness import (CalSample, fit_constants,
                                           run_calibration, run_samples)

__all__ = ["CalSample", "fit_constants", "run_calibration", "run_samples"]
