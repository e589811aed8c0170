"""Training cells: the port's ``train.loop.run_xr_training``, the entry of
``launch.train_xr``, on an ``XRNet`` holding the seed's weights.

Set-up builds the net, loads the weights, renders a pool of host batches
and calls the entry once with a step count no window reaches. Its first
``warm_steps`` steps are set-up; the heartbeat hook records each step, so
the window opens at the heartbeat of the last of them and closes at the
first heartbeat ``seconds`` later, after which ``trace`` steps more may be
profiled. One step more, past the schedule's warm-up, is the late check
step; at its heartbeat the hook raises SIGTERM, which the entry takes as a
preemption and ends its loop after that step. The precision is the
entry's (float32, TF32 off); the loss is the entry's for the task.

The check follows the first ``checked_steps`` steps, which ran on pool
batches whose rows all differ, with the plain reference: each step's loss,
the first step's gradient as the optimizer got it (clipped), worked out
from the entry's AdamW state after that step, the parameters' change and
the BN state after the last checked step. From the program's own state
before the late step (parameters, BN state, AdamW moments) the reference
takes that step too: its loss, its clipped gradient (from the moments
before and after), and the AdamW update that the moments after it give,
decay included. The entry hands its optimizer state to no hook, so the
heartbeat reads it from the entry's frame, by its type (``AdamWState``).
"""
from __future__ import annotations

import signal
import sys
import time
from typing import Dict, Iterator, List

import torch

from portbench.drivers import xr_common as common
from portbench.inputs import xr as inputs
from portbench.lib.outcome import Outcome, leaf_gap
from portbench.lib.window import Window
from portbench.reference import xr as ref

KIND = "train"
LOSSES = {"detection": "circle_loss", "segmentation": "dice_loss"}
BASE_LR = 3e-3            # the launcher's default rate
STEPS = 10 ** 9           # a step count no window reaches
WARMUP = 50               # the entry's schedule warms up over min(50, ...)
NOUGHT = 1e-3             # leaves under this share of the median leaf's
                          # gradient move by rounding alone under AdamW
B1 = 0.9                  # AdamW's first-moment decay, the launcher's
CONTROLS = ("tf32",)      # float32 with TF32 on, the program's own path


def _feed(pool: List[Dict]) -> Iterator:
    i = 0
    while True:
        yield pool[i % len(pool)], i + 1
        i += 1


def entry_state():
    """The entry's AdamW state, as it stands at a heartbeat: the nearest
    caller's local of type ``AdamWState``."""
    from repro_torch.train import optim
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, optim.AdamWState):
                return v
        f = f.f_back
    raise RuntimeError("no AdamW state among the entry's locals")


def _copy(tensors: Dict) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


def run(cell, seed: int, seconds: float, trace: bool, device,
        control: str = "") -> Outcome:
    from repro_torch.models import xr
    from repro_torch.train import loop

    cfg, tr = cell.config, cell.traffic
    B, warm, checked = tr["batch"], tr["warm_steps"], tr["checked_steps"]
    if not checked < warm < WARMUP:
        raise ValueError("the checked steps are set-up, inside the warm-up")
    if control and control not in CONTROLS:
        raise ValueError(f"no control {control!r} in training")
    common.set_tf32(control == "tf32")
    t = [time.perf_counter()]
    w0 = inputs.weights(cfg, seed, device)
    pool = [inputs.to_host(b)
            for b in inputs.batches(cfg, seed, 0, tr["pool"], B, device)]
    t.append(time.perf_counter())
    net = xr.XRNet(common.program_config(cfg), torch.Generator().manual_seed(0),
                   device=device)
    net.load_state_dict(w0)
    t.append(time.perf_counter())
    step_s: List[float] = []

    first: Dict[str, torch.Tensor] = {}
    after: Dict[str, torch.Tensor] = {}
    late: Dict = {}
    window = Window(seconds, trace, tr["trace_steps"])

    def heartbeat(step: int, dt: float) -> None:
        if step < warm:
            step_s.append(dt)
        if step == 0:
            first.update({k: m / (1 - B1) for k, m in entry_state().m.items()})
        if step == checked - 1:
            after.update(_copy(net.state_dict()))
        if step == warm - 1:
            window.start()
        elif step >= warm and not window.done:
            window.tick(B)
        if not window.done:
            return
        if late.get("step") == step:
            signal.raise_signal(signal.SIGTERM)
        elif not late and step + 1 >= WARMUP:
            st = entry_state()
            late.update(step=step + 1, before=_copy(net.state_dict()),
                        m=_copy(st.m), v=_copy(st.v))

    res = loop.run_xr_training(
        net, _feed(pool), loss_fn=getattr(xr, LOSSES[cfg["task"]]),
        steps=STEPS, lr=BASE_LR,
        hooks=loop.TrainHooks(heartbeat=heartbeat, log_every=0))
    if not late or res.step != late["step"] + 1:
        raise RuntimeError(f"the entry stopped after {res.step} steps, "
                           "before the late check step")
    peak = common.peak_bytes(device)
    late.update(loss=res.losses[-1], after=dict(res.params),
                m_after=res.opt_state.m, v_after=res.opt_state.v)
    losses = res.losses[:checked]
    del net, res
    common.free(device)

    checks, where = check(cell, w0, pool, losses, first, after, late, device)
    rate = window.items / window.elapsed
    setup = {"inputs": t[1] - t[0], "net": t[2] - t[1],
             "first_step": step_s[0], "warm_steps": sum(step_s[1:])}
    return Outcome("train", B, window, {"train_items_per_s": rate},
                   window.units, 0, peak, checks,
                   common.work_counts(cfg, B, "train"), where, setup)


def check(cell, w0, pool, losses, first, after, late, device):
    """The first steps and the late step against the reference:
    ({name: (value, limit)}, {name: the worst leaf})."""
    cfg, tr = cell.config, cell.traffic
    checked, n_pool = tr["checked_steps"], tr["pool"]
    common.set_tf32(False)

    def on_device(b):
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    p0, s0 = ref.split(w0)
    lrs = [ref.warmup_lr(BASE_LR, s, WARMUP) for s in range(checked)]
    r_losses, r_first, r_p, r_s = ref.train_steps(
        cfg, p0, s0, [on_device(b) for b in pool[:checked]], lrs)
    missing = sorted(set(p0) - set(first))
    if missing:
        raise RuntimeError(f"no gradient was read from {missing[:4]}")
    loss_gap = rel_gaps(losses, r_losses)
    grad_gap, grad_at = leaf_gap(first, r_first, p0)
    gnorm = {k: float(r_first[k].double().norm()) for k in p0}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    moved = [k for k in p0 if gnorm[k] >= NOUGHT * med]
    d_prog = {k: after[k] - p0[k] for k in moved}
    d_ref = {k: r_p[k] - p0[k] for k in moved}
    change_gap, change_at = leaf_gap(d_prog, d_ref, moved)
    bn_gap, bn_at = leaf_gap(after, r_s, s0)

    # the late step, from the program's own state before it
    n = late["step"]
    lp, ls = ref.split(late["before"])
    lr = ref.schedule_lr(BASE_LR, n, WARMUP, STEPS)
    l_losses, l_grad, _, _ = ref.train_steps(
        cfg, lp, ls, [on_device(pool[n % n_pool])], [lr],
        moments=(late["m"], late["v"]), count=n)
    late_loss_gap = rel_gaps([late["loss"]], l_losses)
    got = {k: (late["m_after"][k] - B1 * late["m"][k]) / (1 - B1) for k in lp}
    late_grad_gap, late_grad_at = leaf_gap(got, l_grad, lp)
    upd = {k: ref.adamw_apply(lp[k], late["m_after"][k], late["v_after"][k],
                              n + 1, lr) - lp[k] for k in lp}
    adam_gap, adam_at = leaf_gap({k: late["after"][k] - lp[k] for k in lp},
                                 upd, lp)
    lim = cell.limits
    values = {"loss_gap": loss_gap, "grad_gap": grad_gap,
              "change_gap": change_gap, "bn_gap": bn_gap,
              "late_loss_gap": late_loss_gap, "late_grad_gap": late_grad_gap,
              "adam_gap": adam_gap}
    return ({k: (v, lim[k]) for k, v in values.items()},
            {"grad_gap": grad_at, "change_gap": change_at, "bn_gap": bn_at,
             "late_grad_gap": late_grad_at, "adam_gap": adam_at,
             "late_step": str(n)})


def rel_gaps(got: List[float], want: List[float]) -> float:
    """The largest gap of a loss from the reference's, over the
    reference's; infinity where the counts differ."""
    if len(got) != len(want):
        return float("inf")
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))
