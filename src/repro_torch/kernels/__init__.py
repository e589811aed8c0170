"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot path.

  int8_matmul      -- INT8 GEMM with fused per-row x per-column dequant
  depthwise_conv   -- NHWC 3x3 depthwise (MobileNetV2 IRB hot path)
  quantize         -- fused absmax -> scale -> round -> clip row quant
  flash_attention  -- online-softmax attention (LM prefill and training,
                      grouped heads) and its backward
  ssd_scan         -- Mamba-2 SSD inter-chunk state scan and its backward

Each kernel has a plain PyTorch version in ``ref``; ``ops`` dispatches by
device. Sources are in ``csrc/``, built at first use by ``_build``.
"""
