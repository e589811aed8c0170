"""The pricing plane (step 4 of the paper's pipeline): layer specs priced
against SRAM and MRAM memory hierarchies, in numpy on the host.

A copy of ``repro.core`` (the JAX package's numpy plane, which imports no
JAX), held byte for byte to it by ``tests/test_torch_pricing.py``. Left
out: ``roofline`` (TPU figures; it waits for the H100's own, with
sharding), the streaming and trace planes (``Evaluator.evaluate_stream``,
``trace_table``, ``evaluate_trace``, ``DesignSpace.product_iter``, the
``"trace"`` sweep and ``dse.sweep_trace``). XR specs come from
``repro_torch.models.xr``; the constants from this package's
``calibrate/calibrated.json``.
"""
