"""Faults planted under the timed path, to show that the check catches
them: each is a context manager that patches one function of the port for
its duration. ``readings.py`` reads them on the card and the tests drive a
whole run with each on the CPU.

  * ``state_unchanged`` (training): AdamW returns the parameters as they
    were, so no step moves the net;
  * ``half_batch`` (training): the loss is taken over the first half of
    the batch only, the mean over those rows;
  * ``no_clip`` (training): the global-norm clip hands the gradients on
    unscaled (the norm is still returned);
  * ``no_decay`` (training): AdamW runs with no weight decay;
  * ``half_batch`` (INT8): ``forward_int8`` evaluates the first half of
    the batch and answers nothing (zeros) for the rest;
  * ``answer_altered`` (INT8): ``forward_int8`` answers the first image
    of every batch with its outputs negated.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator


@contextlib.contextmanager
def _patched(module, name: str, make: Callable) -> Iterator[None]:
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def state_unchanged():
    from repro_torch.train import optim

    def make(original):
        def adamw_update(grads, state, params, **kw):
            _, new_state = original(grads, state, params, **kw)
            return {k: p.clone() for k, p in params.items()}, new_state
        return adamw_update
    return _patched(optim, "adamw_update", make)


def no_clip():
    from repro_torch.train import optim

    def make(original):
        def clip_by_global_norm(grads, max_norm):
            return dict(grads), optim.global_norm(grads)
        return clip_by_global_norm
    return _patched(optim, "clip_by_global_norm", make)


def no_decay():
    from repro_torch.train import optim

    def make(original):
        def adamw_update(grads, state, params, **kw):
            return original(grads, state, params, **dict(kw, weight_decay=0.0))
        return adamw_update
    return _patched(optim, "adamw_update", make)


def _halves(d: Dict, n: int) -> Dict:
    return {k: v[:n] if hasattr(v, "shape") and v.dim() and v.shape[0] == 2 * n
            else v for k, v in d.items()}


@contextlib.contextmanager
def train_half_batch():
    from repro_torch.models import xr

    def make(original):
        def loss(outputs, batch, *a, **kw):
            n = batch["image"].shape[0] // 2
            return original(_halves(outputs, n), _halves(batch, n), *a, **kw)
        return loss
    with _patched(xr, "circle_loss", make), _patched(xr, "dice_loss", make):
        yield


def infer_half_batch():
    from repro_torch.quant import ptq

    def make(original):
        def forward_int8(net, images, *a, **kw):
            n = images.shape[0] // 2
            outs, st = original(net, images[:n], *a, **kw)
            full = {}
            for k, v in outs.items():
                z = v.new_zeros((images.shape[0],) + tuple(v.shape[1:]))
                z[:n] = v
                full[k] = z
            return full, st
        return forward_int8
    return _patched(ptq, "forward_int8", make)


def answer_altered():
    from repro_torch.quant import ptq

    def make(original):
        def forward_int8(net, images, *a, **kw):
            outs, st = original(net, images, *a, **kw)
            for v in outs.values():
                v[0] = -v[0]
            return outs, st
        return forward_int8
    return _patched(ptq, "forward_int8", make)


FAULTS = {"train": {"state_unchanged": state_unchanged,
                    "half_batch": train_half_batch,
                    "no_clip": no_clip, "no_decay": no_decay},
          "infer": {"half_batch": infer_half_batch,
                    "answer_altered": answer_altered}}
