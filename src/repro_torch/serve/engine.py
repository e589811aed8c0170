"""Batched serving engine with continuous batching, port of
``repro.serve.engine``.

Every engine iteration is ONE batched ``lm.decode_step``. Slots are in one
of three roles per iteration:

  * prefilling -- feeds the next prompt token (the cache fills; logits are
    ignored until the last prompt token, whose logits give the first
    generated token),
  * decoding   -- feeds its previously generated token, emits the next,
  * idle       -- feeds a pad token at position 0 (its state is reset on
    refill).

Prefill rides on the decode batch (no separate prefill pass, no stalls),
which is also right for SSM layers, whose recurrent state updates are not
idempotent. The cache is a dict of stacked tensors on the device that
``decode_step`` updates in place. INT8 weight PTQ is optional
(``quant/ptq.py``).

The server is text-only, as the reference's: a VLM's decode takes no image
embeddings, and an encoder-decoder's cross-attention cache (xk, xv) stays
zero (the reference creates it zeroed, zeroes it again per admitted
request, and never fills it), so its cross-attention adds exactly 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import lm


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


@dataclass
class _Slot:
    req: Request
    cursor: int = 0                  # next prompt token to feed
    next_token: int = -1             # set once prefill completes
    pos: int = 0                     # tokens written to the cache

    @property
    def prefilling(self) -> bool:
        return self.cursor < len(self.req.prompt)


def _to(tree: Dict, dev: torch.device) -> Dict:
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Dict, *, batch_size: int = 4,
                 max_seq: int = 256, eos_id: Optional[int] = None,
                 quantize: bool = False, device: DeviceLike = "cuda"):
        self.cfg, self.B, self.S = cfg, batch_size, max_seq
        self.device = resolve_device(device)
        params = _to(params, self.device)
        if quantize:
            from repro_torch.quant import ptq
            params = ptq.quantize_params(params, channel_axis=-1)
        self.params = params
        self.eos_id = eos_id
        self.cache = lm.init_cache(cfg, batch_size, max_seq, self.device)
        self.slots: List[Optional[_Slot]] = [None] * batch_size
        self.queue: List[Request] = []

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request):
        self.queue.append(req)

    def step(self) -> List[Request]:
        """One batched decode step across all slots. Returns completions."""
        self._refill()
        if all(s is None for s in self.slots):
            return []
        tokens = np.zeros((self.B, 1), np.int32)
        positions = np.zeros(self.B, np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tokens[i, 0] = (int(s.req.prompt[s.cursor]) if s.prefilling
                            else s.next_token)
            positions[i] = s.pos
        with torch.no_grad():
            logits, self.cache = lm.decode_step(
                self.cfg, self.params, self.cache,
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(positions).to(self.device))
        logits = logits.cpu().numpy()

        done: List[Request] = []
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            s.pos += 1
            if s.prefilling:
                s.cursor += 1
                if s.prefilling:          # more prompt left: ignore logits
                    continue
            nxt = int(np.argmax(logits[i]))
            s.req.out_tokens.append(nxt)
            s.next_token = nxt
            if (len(s.req.out_tokens) >= s.req.max_new_tokens
                    or s.pos >= self.S - 1
                    or (self.eos_id is not None and nxt == self.eos_id)):
                s.req.done = True
                done.append(s.req)
                self.slots[i] = None
        return done

    def run(self, max_iters: int = 10_000) -> List[Request]:
        out = []
        for _ in range(max_iters):
            out += self.step()
            if not self.queue and all(s is None for s in self.slots):
                break
        return out

    # -- internals -----------------------------------------------------------
    def _refill(self):
        for i in range(self.B):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self._reset_slot(i)
                self.slots[i] = _Slot(req)

    def _reset_slot(self, i: int):
        """Zero slot i's cache rows in place, every leaf: SSM states are
        recurrent (a stale state would leak into the next request);
        attention rows, the ring caches of sliding-window layers included,
        are masked by position, but are cleared all the same, and so are
        the cross-attention caches."""
        def zero(tree):
            for v in tree.values():
                if isinstance(v, dict):
                    zero(v)
                else:
                    v[:, i].zero_()
        zero(self.cache)
