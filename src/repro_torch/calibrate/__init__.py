"""Kernel calibration corners of the compute-plane constants, on the card.

See ``repro_torch.calibrate.harness``. ``calibrated.json`` here is a byte
copy of the JAX package's fit, which ``repro_torch.core.devices`` reads;
``calibrated_h100.json`` is the port's own refit on the card, which
``write_calibrated`` writes and ``check`` gates against.
"""
from repro_torch.calibrate.harness import (CALIB_PATH, CalSample,
                                           calibration_data, check,
                                           fit_constants, run_calibration,
                                           run_samples, write_calibrated)

__all__ = ["CALIB_PATH", "CalSample", "calibration_data", "check",
           "fit_constants", "run_calibration", "run_samples",
           "write_calibrated"]
