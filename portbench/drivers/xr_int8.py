"""INT8 evaluation cells: the port's ``quant.ptq.forward_int8``, the
launcher's evaluation (``launch.train_xr.evaluate``): per-channel INT8
fake-quant of every conv and dense weight at each call, then the eval-mode
forward, in a closed loop of one client.

Activations stay float32. With activation fake-quant (``calibrate_acts``)
a random-weight net's answers are quantization noise: on the CPU, at full
width, DetNet's W8A8 answers lie 1.15 median answers from its float
answers, and a 1e-7 nudge of the input moves them by 0.30, so no answer
can be held to a reference (PERF.md, section 6).

Set-up builds the net with the seed's weights, sets its BN statistics to
those of ``stats_batch`` images (``XRNet.set_bn_stats``, as a trained net's
EMA holds them), renders a pool of host batches and runs ``warm_requests``
requests. A request is one host batch: copied to the card,
``forward_int8``, then a wait for the device; its latency runs from the
copy to the end of the wait.

The check keeps the outputs of ``sampled_requests`` requests of the window
(a reservoir sample drawn from the seed) and, once the window has closed,
holds every image's answer, in every head, to the plain reference, which
sets its own BN statistics and quantizes its own weights from the same
inputs and runs the same batch.
"""
from __future__ import annotations

import random
import statistics
import time
from typing import Dict, List

import torch

from portbench.drivers import xr_common as common
from portbench.inputs import xr as inputs
from portbench.lib.outcome import Outcome
from portbench.lib.window import Window
from portbench.reference import xr as ref

KIND = "infer"
# The controls, one precision below what the configuration states:
# "bits4", 4-bit weight codes for INT8 ones (the program's own option);
# "tf32", the activations' float32 with TF32 on (the program's own path);
# "bf16", the reference in the program's place under bfloat16 autocast.
CONTROLS = ("bits4", "tf32", "bf16")


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: str = "") -> Outcome:
    from repro_torch.models import xr
    from repro_torch.quant import ptq

    cfg, tr = cell.config, cell.traffic
    B, n_pool = tr["batch"], tr["pool"]
    if tr["clients"] != 1:
        raise ValueError("the INT8 driver runs one closed-loop client")
    if control and control not in CONTROLS:
        raise ValueError(f"no control {control!r} in INT8 evaluation")
    bits = 4 if control == "bits4" else tr["bits"]
    common.set_tf32(control == "tf32")
    t = [time.perf_counter()]
    w0 = inputs.weights(cfg, seed, device)
    stats = inputs.batches(cfg, seed, n_pool * B, 1, tr["stats_batch"],
                           device)[0]["image"]
    pool = [inputs.to_host(b)["image"]
            for b in inputs.batches(cfg, seed, 0, n_pool, B, device)]
    t.append(time.perf_counter())
    net = xr.XRNet(common.program_config(cfg), torch.Generator().manual_seed(0),
                   device=device)
    net.load_state_dict(w0)
    net.set_bn_stats(stats)
    t.append(time.perf_counter())
    answer = (bf16_reference(cfg, w0, stats, bits, device) if control == "bf16"
              else lambda x: ptq.forward_int8(net, x, bits=bits)[0])

    def request(i: int):
        t = time.perf_counter()
        x = torch.from_numpy(pool[i % n_pool]).to(device)
        outs = answer(x)
        common.sync(device)
        return outs, time.perf_counter() - t

    warm = [request(i)[1] for i in range(tr["warm_requests"])]
    k, rng = tr["sampled_requests"], random.Random(seed)
    kept: List = []                      # (pool index, outputs)
    lat: List[float] = []
    window = Window(seconds, trace, tr["trace_requests"])
    window.start()
    i = 0
    while True:
        outs, dt = request(i)
        if window.open:
            j = len(lat)
            lat.append(dt)
            slot = j if j < k else rng.randrange(j + 1)
            if slot < k:
                if slot < len(kept):
                    kept[slot] = (i % n_pool, outs)
                else:
                    kept.append((i % n_pool, outs))
        if window.tick(B):
            break
        i += 1
    peak = common.peak_bytes(device)
    del net, outs
    common.free(device)

    checks = check(cell, w0, stats, pool, kept, device)
    e2e = {"infer_items_per_s": window.items / window.elapsed,
           "infer_batch_ms_p95": 1e3 * p95(lat)}
    setup = {"inputs": t[1] - t[0], "net_and_bn_stats": t[2] - t[1],
             "first_request": warm[0], "warm_requests": sum(warm[1:])}
    return Outcome("infer", B, window, e2e, len(lat), 0, peak, checks,
                   common.work_counts(cfg, B, "infer"), setup=setup)


def bf16_reference(cfg, w0, stats, bits: int, device):
    """The "bf16" control's answers: the reference's quantized forward
    under bfloat16 autocast, as float32."""
    p0, s0 = ref.split(w0)
    state = ref.bn_stats(cfg, p0, s0, stats)
    qp = ref.quantize_weights(p0, bits)

    def answer(x):
        with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
            outs = ref.int8_forward(cfg, qp, state, x)
        return {k: v.float() for k, v in outs.items()}
    return answer


def p95(values: List[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def check(cell, w0, stats, pool, kept, device):
    """Every image of the sampled requests against the reference."""
    cfg, tr = cell.config, cell.traffic
    common.set_tf32(False)
    p0, s0 = ref.split(w0)
    state = ref.bn_stats(cfg, p0, s0, stats)
    qp = ref.quantize_weights(p0, tr["bits"])
    want: Dict[int, Dict[str, torch.Tensor]] = {}
    gap = 0.0 if kept else float("inf")
    for idx, outs in kept:
        if idx not in want:
            x = torch.from_numpy(pool[idx]).to(device)
            want[idx] = ref.int8_forward(cfg, qp, state, x)
        gap = max(gap, answers_gap(outs, want[idx]))
    return {"out_gap": (gap, cell.limits["out_gap"])}


def answers_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
                ) -> float:
    """Each image's answer in each head: the norm of its difference from
    the reference's, over the median image's norm of the reference's
    answer in that head; the largest. A head missing reads infinity."""
    worst = 0.0
    for head, w in want.items():
        if head not in got or got[head].shape != w.shape:
            return float("inf")
        g = got[head].double().reshape(w.shape[0], -1)
        w = w.double().reshape(w.shape[0], -1)
        scale = max(float(w.norm(dim=1).median()), 1e-30)
        diff = float((g - w).norm(dim=1).max())
        worst = max(worst, diff / scale if diff == diff else float("inf"))
    return worst
