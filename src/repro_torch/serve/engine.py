"""Continuous-batching serving engine (slots), twin of ``repro/serve/engine.py``.

A fixed pool of ``max_batch`` slots shares one pre-allocated cache of length
``max_seq``. Requests are admitted into free slots as they arrive (prompt
prefilled at batch 1 and scattered into the slot), every engine step decodes
all slots at their own positions, and a finished request frees its slot at
once for the next waiting one. Idle slots decode into their own cache rows
with their positions frozen; their outputs are ignored and their rows are
re-prefilled on admission, so they cannot touch live requests.

This is the per-step oracle: one decode per step and a host read of every
slot's token. ``serve/compiled.py`` is the engine with a compiled hot loop
(K decode steps a host call, as one CUDA graph on the card) that it
holds token for token. Requests are text: the vlm family (qwen2-vl) is served
without vision embeddings, as by the reference's engine, its M-RoPE
decode positions each slot's position in all three components.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class Request:
    rid: int
    prompt: torch.Tensor                 # (S,) integer token ids
    max_new_tokens: int
    eos_id: Optional[int] = None
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # the weight generation the request was admitted under (the compiled
    # engine pins it; None on this engine, which serves one param set)
    generation: Optional[int] = None
    # admission deadline (compiled engine): seconds from submit within
    # which the request must be admitted, else it is shed with
    # rejected=True, done=True; None defers to the engine's
    # admit_timeout_s (None there: wait indefinitely). submit_t is stamped
    # by the engine's clock at submit(). This engine ignores all three.
    deadline_s: Optional[float] = None
    submit_t: Optional[float] = None
    rejected: bool = False


def _insert(dst, src, slot: int, batch_dim: int) -> None:
    """Write row 0 of a batch-1 cache tree into ``slot`` of the engine's."""
    if isinstance(dst, dict):
        for k in dst:
            _insert(dst[k], src[k], slot, batch_dim)
        return
    dst.select(batch_dim, slot).copy_(src.select(batch_dim, 0))


class ServingEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_seq: int = 256):
        if model.cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{model.cfg.name}: the continuous engine takes no encoder "
                f"frames (nor does the reference's, repro/serve/engine.py); "
                f"serve the audio family with launch.serve.generate("
                f"..., extras={{'frames': ...}})")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = params["embed"]["table"].device
        self.cache = model.empty_cache(max_batch, max_seq, self.device)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        # next write position and next input token of every slot
        self.positions = torch.zeros(max_batch, dtype=torch.long,
                                     device=self.device)
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.long,
                                  device=self.device)
        self.waiting: List[Request] = []

    # ------------------------------------------------------------------

    def submit(self, request: Request) -> None:
        S = request.prompt.shape[0]
        if S > self.max_seq:
            raise ValueError(
                f"prompt of {S} tokens cannot fit the engine cache "
                f"(max_seq={self.max_seq})")
        self.waiting.append(request)
        self._admit()

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        # free slots are found anew each time: a request that finishes at
        # admission leaves its slot to the next waiting one in this pass
        while self.waiting:
            free = self._free_slots()
            if not free:
                return
            slot = free[0]
            req = self.waiting.pop(0)
            prompt = req.prompt.to(device=self.device, dtype=torch.long)
            logits, pc = self.model.prefill(self.params, prompt[None, :],
                                            cache_len=self.max_seq)
            self._insert_cache(pc, slot)
            tok = int(torch.argmax(logits[0], -1))
            self.tokens[slot, 0] = tok
            self.positions[slot] = prompt.shape[0]
            req.generated = [tok]
            self.slot_req[slot] = req
            self._maybe_finish(slot)

    def _insert_cache(self, prefill_cache, slot: int) -> None:
        """Scatter a batch-1 prefill cache into the engine cache slot. Leaves
        under the stacked ``units`` subtree carry the unit axis first, so
        their batch dim is 1."""
        for key, sub in self.cache.items():
            _insert(sub, prefill_cache[key], slot,
                    1 if key == "units" else 0)

    def _maybe_finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is None:
            return
        if (len(req.generated) >= req.max_new_tokens
                or (req.eos_id is not None and req.generated
                    and req.generated[-1] == req.eos_id)
                or int(self.positions[slot]) >= self.max_seq - 1):
            req.done = True
            self.slot_req[slot] = None

    # ------------------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def step(self) -> None:
        """One decode step for all slots."""
        if self.active == 0:
            return
        logits, self.cache = self.model.decode(self.params, self.cache,
                                               self.tokens, self.positions)
        next_tok = torch.argmax(logits, -1)                    # (B,)
        self.tokens = next_tok[:, None]
        # advance active slots only: an idle slot's position stays frozen
        active = torch.tensor([r is not None for r in self.slot_req],
                              device=self.device)
        self.positions = torch.where(active, self.positions + 1,
                                     self.positions)
        host_tok = next_tok.tolist()
        for slot, req in enumerate(self.slot_req):
            if req is not None:
                req.generated.append(host_tok[slot])
                self._maybe_finish(slot)
        self._admit()

    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> Dict[int, List[int]]:
        """Serve a list of requests to completion; returns rid -> tokens."""
        for r in requests:
            self.submit(r)
        steps = 0
        while (self.active or self.waiting) and steps < max_steps:
            self.step()
            steps += 1
        return {r.rid: r.generated for r in requests}
