from repro_torch.quant.ptq import (calibrate_acts, fake_quant, forward_int8,
                                   quantize_params, quantize_tensor,
                                   weight_histogram)

__all__ = ["calibrate_acts", "fake_quant", "forward_int8", "quantize_params",
           "quantize_tensor", "weight_histogram"]
