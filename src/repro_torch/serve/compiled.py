"""Compiled continuous-batching engine, twin of ``repro/serve/compiled.py``
(single device).

The per-step ``ServingEngine`` (``serve/engine.py``, kept as the
token-exact oracle) runs one decode a Python iteration and reads every
slot's token back after each. This engine moves the hot loop onto the
device:

  * **Device-resident scheduler state.** Each slot's next token, write
    position, active flag, remaining budget and EOS id, the sampling key,
    the block tables and a (B, K) token buffer live on the device beside
    the cache, in a ``DecodeState`` allocated once at construction.
    Admission writes into these tensors in place, so a captured graph
    never goes stale. The host keeps the request queue and a replay
    mirror.

  * **K decode steps as one CUDA graph.** ``decode_block`` (K) model steps,
    each with its sampling (argmax, or Gumbel noise from ``data/prng.py``
    under a key split on the device), EOS detection, per-slot stopping and
    position/budget bookkeeping, run as one ``torch.cuda.CUDAGraph``
    captured once (after a warm-up on a copy of the state, on a side
    stream). Each layer writes its new cache row in place
    (``Model.decode(..., inplace=True)``), so a step copies no cache. A
    ``step()`` copies dirty block tables to the device, replays the graph
    and reads the (B, K) block back once: ``decode_transfers ==
    decode_calls``. The host replays the device's stop rule from that
    block alone. On the CPU (the caller's choice, by the params' device)
    the same K-step function runs eagerly; on CUDA ``cuda_graph=False``
    runs it eagerly too, which is how the graph is held against it. A
    capture or replay that fails raises: nothing drops to eager quietly.

  * **Bucketed prefill.** Prompts are right-padded to a few bucket lengths
    (always completed with ``max_seq``), and ``Model.prefill(length=)``
    makes the padding exact: the logits, window slots and SSM states of
    the unpadded prompt.

  * **Paged KV cache.** With ``kv_layout="paged"`` (what ``"auto"`` picks
    when the model has full-attention GQA layers) those layers' K/V live in
    one page pool with per-slot block tables, allocated on the host between
    decode calls: admission reserves a request's worst case of pages (so
    growth never exhausts the pool) and allocates the prompt's, decode
    grows a slot page by page, a finished request returns its pages.
    ``kv_cache_dtype="int8"`` quantizes the pool per (token, head).
    Window, SSM, MLA and cross caches keep their dense layout in the same
    tree.

  * **Admission deadlines.** ``admit_timeout_s`` (engine-wide) and
    ``Request.deadline_s`` (per request) bound how long a request may wait
    for admission; past it the request is shed with ``rejected=True`` and
    counted in ``stats["rejections"]``. ``clock`` is injectable.

  * **Live weight publishing.** ``publish(params)`` swaps in a new weight
    generation (the phase-2 running average of
    ``serve.publish.WeightPublisher``) without dropping in-flight
    requests. The params are double-buffered in tensors the engine owns:
    a publish copies into the buffer no in-flight request is pinned to
    (at once, or deferred until its requests drain; a newer publish
    supersedes a queued one, a stale one is refused), and never writes
    into the caller's tensors. Each slot is pinned to the buffer it was
    admitted on. While both generations have requests, a step runs the
    dual K-step block: each model step evaluates both weight sets on the
    one cache, each writing only the rows, pages and SSM states of its own
    slots (``decode(write_mask=)``), and the logits are selected per slot,
    so every request's tokens equal a single-generation engine's on its
    weights. The per-slot selector is copied from pinned host memory
    before the replay: still one block read a decode call. On the card
    each buffer has its own single-generation graph and the dual block a
    third, sharing one memory pool; ``warmup(dual=True)`` takes the
    engine's own copies of both buffers and captures all three, after
    which neither ``publish`` nor ``step`` captures.

Scheduling differs from the oracle (admissions happen between K-token
blocks), but each request's tokens are exact: a slot's output depends only
on its own cache rows, which admission re-prefills. Placement over a
device mesh (``dist=``) is refused: serving across cards is ROADMAP A13c.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data import prng
from repro_torch.dist.sharding import cache_batch_dim, page_pool_dim
from repro_torch.models.model import Model
from repro_torch.optim.api import tree_map
from repro_torch.serve.engine import Request


class DecodeState(NamedTuple):
    """Device-resident scheduler state, one entry a slot; the engine
    updates every tensor in place."""

    cache: Any                   # model KV/SSM cache, batch dim = slots
    tokens: torch.Tensor         # (B,) long: next input token a slot
    positions: torch.Tensor      # (B,) long: cache position it writes to
    active: torch.Tensor         # (B,) bool: slot currently generating
    remaining: torch.Tensor      # (B,) long: decode steps left
    eos: torch.Tensor            # (B,) long: EOS id a slot, -1 = none
    rng: torch.Tensor            # (2,) int64 key for categorical sampling
    block_tables: torch.Tensor   # (B, M) long page ids; (B, 0) when dense


def default_buckets(max_seq: int, lo: int = 16) -> Tuple[int, ...]:
    """Doubling prompt-length buckets: lo, 2lo, ... capped at max_seq."""
    buckets: List[int] = []
    b = lo
    while b < max_seq:
        buckets.append(b)
        b *= 2
    buckets.append(max_seq)
    return tuple(buckets)


def _flatten(tree, prefix: str = ""):
    """{"units/0/a/k": leaf, ...}: the reference's key paths."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


class CompiledServingEngine:
    """Sibling of ``ServingEngine`` with a compiled hot loop and live
    weight publishing.

    Args beyond the oracle's: ``decode_block`` (K: model steps a host
    call), ``prefill_buckets`` (padded prompt lengths; None: the doubling
    set of ``default_buckets``; always completed with ``max_seq``),
    ``sample`` ("greedy" | "categorical"), ``temperature`` and ``rng`` (a
    ``data.prng`` key) for sampling. Paged cache: ``kv_layout`` ("dense",
    "paged", or "auto": paged iff the model has a pageable layer),
    ``page_size``, ``n_pages`` (the pool, the null page 0 included; None:
    as many as the dense layout holds, so admission never waits for pages
    by default), ``kv_cache_dtype`` (overrides the config's, e.g. "int8",
    by rebuilding the Model, so prefill, decode and the pool quantize
    alike). Deadlines: ``admit_timeout_s`` and ``clock``, as in the class
    docstring of the module. ``generation``: the weight generation of
    ``params``. ``cuda_graph``: on CUDA, replay the K-step blocks as
    captured graphs (True) or run them eagerly (False); the CPU always runs
    them eagerly. The engine serves on its params' device.
    """

    def __init__(self, model: Model, params, *, max_batch: int = 4,
                 max_seq: int = 256, decode_block: int = 8,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 sample: str = "greedy", temperature: float = 1.0,
                 rng=None, generation: int = 0,
                 kv_layout: str = "auto", page_size: int = 16,
                 n_pages: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = None,
                 dist=None, admit_timeout_s: Optional[float] = None,
                 clock=time.monotonic, cuda_graph: bool = True):
        if sample not in ("greedy", "categorical"):
            raise ValueError(f"unknown sample mode {sample!r}")
        if kv_layout not in ("auto", "paged", "dense"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if dist is not None:
            raise NotImplementedError(
                "CompiledServingEngine(dist=...): placing the decode state "
                "over a device mesh is not ported (ROADMAP A13c)")
        if model.cfg.is_encoder_decoder:
            raise NotImplementedError(
                f"{model.cfg.name}: the continuous engine takes no encoder "
                f"frames (nor does the reference's, repro/serve/engine.py); "
                f"serve the audio family with launch.serve.generate("
                f"..., extras={{'frames': ...}})")
        if kv_cache_dtype is not None \
                and kv_cache_dtype != model.cfg.kv_cache_dtype:
            # rebuilt on the new config, so that the prefill, the in-loop
            # decode writes and the pool all quantize alike
            model = Model(dataclasses.replace(
                model.cfg, kv_cache_dtype=kv_cache_dtype))
        if admit_timeout_s is not None and admit_timeout_s <= 0:
            raise ValueError(
                f"admit_timeout_s must be positive (None = no bound), "
                f"got {admit_timeout_s}")
        self.admit_timeout_s = admit_timeout_s
        self._clock = clock
        self.model = model
        self.device = params["embed"]["table"].device
        # double-buffered params: buffer j holds generation _buf_gen[j],
        # _latest names the one new admissions pin to. Buffer 0 starts as
        # the caller's tensors (_owned False) and is never written: a
        # publish into it, or warmup(dual=True), first makes it the
        # engine's own copy
        self._buffers: List[Any] = [params, None]
        self._buf_gen: List[int] = [generation, generation - 1]
        self._owned: List[bool] = [False, False]
        self._latest: int = 0
        self._pending: Optional[Tuple[int, Any]] = None
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.decode_block = decode_block
        self.sample = sample
        self.temperature = temperature
        if kv_layout == "auto":
            kv_layout = "paged" if model.has_pageable else "dense"
        elif kv_layout == "paged" and not model.has_pageable:
            raise ValueError(
                "kv_layout='paged' but no layer of this model is pageable "
                "(full-attention GQA); use 'dense' or 'auto'")
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        # a paged cache rounds its gathered length up to whole pages; rows
        # past max_seq are never unmasked, so tokens stay exact
        self._cache_len = (-(-max_seq // page_size) * page_size
                           if self._paged else max_seq)
        self._n_blocks = self._cache_len // page_size if self._paged else 0
        if n_pages is None:
            # as many as the dense layout holds, + the null page
            n_pages = max_batch * self._n_blocks + 1
        self.n_pages = n_pages if self._paged else 0
        if self._paged and self.n_pages < 2:
            raise ValueError("paged layout needs n_pages >= 2 "
                             "(page 0 is the reserved null page)")
        # the host's page allocator. Page 0 is never handed out: table
        # entries of unallocated or freed regions stay 0, so a frozen
        # slot's garbage writes land on the null page, whose rows the
        # position mask keeps out of every attention sum
        self._free_pages: List[int] = list(range(1, self.n_pages))
        self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        self.slot_max_blocks: List[int] = [0] * max_batch
        self._host_bt = np.zeros((max_batch, self._n_blocks), np.int64)
        self._bt_dirty = False
        if prefill_buckets:
            bs = sorted({int(b) for b in prefill_buckets if b <= max_seq})
            if not bs or bs[-1] != max_seq:
                bs.append(max_seq)    # every bucket set ends at max_seq, so
            self.buckets = tuple(bs)  # _bucket always finds a real bucket
        else:
            self.buckets = default_buckets(max_seq)
        self._compiled_buckets: set = set()
        self._cuda = self.device.type == "cuda"
        self._use_graph = self._cuda and cuda_graph
        # captured K-step blocks: 0 and 1 single-generation on that buffer,
        # "dual" both; one memory pool for all (they never run at once)
        self._graphs: Dict[Any, torch.cuda.CUDAGraph] = {}
        self._pool = None
        self._captures = 0
        with torch.inference_mode():
            self.state = self._empty_state(
                prng.PRNGKey(0) if rng is None else rng)
            # the (B, K) block of sampled tokens: the one device->host
            # transfer of a decode call
            self._block = torch.zeros((max_batch, decode_block),
                                      dtype=torch.long, device=self.device)
            # the dual block's per-slot selector: True = buffer 1
            self._use_b = torch.zeros((max_batch,), dtype=torch.bool,
                                      device=self.device)
        # host staging of the block tables and the selector (pinned on
        # CUDA, so that the copies to the device are asynchronous)
        self._bt_stage = torch.zeros(self._host_bt.shape, dtype=torch.long,
                                     pin_memory=self._cuda)
        self._sel_stage = torch.zeros((max_batch,), dtype=torch.bool,
                                      pin_memory=self._cuda)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_len: List[int] = [0] * max_batch     # prompt len a slot
        self.slot_buf: List[int] = [0] * max_batch     # pinned param buffer
        self.waiting: List[Request] = []
        # the zero-per-token-round-trip claim is decode_transfers ==
        # decode_calls: one bulk block read a decode call
        self.stats: Dict[str, int] = {
            "decode_calls": 0, "decode_transfers": 0, "decode_steps": 0,
            "admissions": 0, "admit_transfers": 0, "prefill_compiles": 0,
            "publishes": 0, "publish_swaps": 0, "publish_superseded": 0,
            "dual_decode_calls": 0, "admit_page_waits": 0, "rejections": 0,
        }

    @property
    def params(self):
        """The latest published parameter set (what new admissions use)."""
        return self._buffers[self._latest]

    @property
    def generation(self) -> int:
        """The weight generation new admissions are pinned to."""
        return self._buf_gen[self._latest]

    @property
    def graphed(self) -> bool:
        """Whether a K-step block replays as a captured CUDA graph."""
        return bool(self._graphs)

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------

    def _empty_state(self, rng) -> DecodeState:
        B, dev = self.max_batch, self.device
        pool = (self.n_pages, self.page_size) if self._paged else None
        return DecodeState(
            cache=self.model.empty_cache(B, self._cache_len, dev,
                                         page_pool=pool),
            tokens=torch.zeros((B,), dtype=torch.long, device=dev),
            positions=torch.zeros((B,), dtype=torch.long, device=dev),
            active=torch.zeros((B,), dtype=torch.bool, device=dev),
            remaining=torch.zeros((B,), dtype=torch.long, device=dev),
            eos=torch.full((B,), -1, dtype=torch.long, device=dev),
            rng=torch.as_tensor(rng, dtype=torch.long).to(dev).clone(),
            block_tables=torch.zeros((B, self._n_blocks), dtype=torch.long,
                                     device=dev))

    def _next_key(self, st: DecodeState) -> torch.Tensor:
        """Split the state's key on its device: the first half becomes the
        state's key, the second is returned (``jax.random.split``)."""
        keys = prng.split(st.rng)
        st.rng.copy_(keys[0])
        return keys[1]

    def _sample(self, logits, key):
        """(B, vocab) logits -> (B,) long next tokens."""
        if self.sample == "greedy":
            return torch.argmax(logits, -1)
        noise = prng.gumbel(key, tuple(logits.shape),
                            self.device if self._cuda else None)
        return torch.argmax(noise + logits.float() / self.temperature, -1)

    def _advance(self, st: DecodeState, logits) -> torch.Tensor:
        """The bookkeeping after a model step, in place on ``st``: sample,
        then mirror the oracle's step. Positions advance and budgets tick
        on active slots; a slot stops on its budget, its EOS or max_seq-1
        truncation, all checked after the position increment, as in
        ``ServingEngine._maybe_finish``. Stopped and free slots freeze, so
        their garbage rows stay in their own cache rows. Greedy decoding
        leaves the key alone: only categorical sampling reads it."""
        key = self._next_key(st) if self.sample == "categorical" else None
        next_tok = self._sample(logits, key)
        act = st.active
        pos1 = torch.where(act, st.positions + 1, st.positions)
        rem1 = torch.where(act, st.remaining - 1, st.remaining)
        hit_eos = (st.eos >= 0) & (next_tok == st.eos)
        done = (rem1 <= 0) | hit_eos | (pos1 >= self.max_seq - 1)
        st.tokens.copy_(torch.where(act, next_tok, st.tokens))
        st.positions.copy_(pos1)
        st.active.copy_(act & ~done)
        st.remaining.copy_(rem1)
        return next_tok

    def _decode_k(self, st: DecodeState, block: torch.Tensor,
                  key=0) -> None:
        """K decode steps on ``st``, in place; step k's sampled tokens go
        to ``block[:, k]``. ``key``: 0 or 1, every slot on that buffer's
        weights; "dual", each slot on its pinned buffer's (``_use_b``).
        Fixed shapes and no host reads, so that it can be captured as one
        CUDA graph."""
        dec = self.model.decode
        for k in range(self.decode_block):
            args = (st.cache, st.tokens[:, None], st.positions)
            kw = dict(block_tables=st.block_tables, inplace=True)
            if key == "dual":
                # two evaluations from the same cache rows: each writes only
                # its own slots' rows, pages and SSM states, so each reads
                # for its slots the cache a single-generation step would
                use_b = self._use_b
                la, _ = dec(self._buffers[0], *args, write_mask=~use_b, **kw)
                lb, _ = dec(self._buffers[1], *args, write_mask=use_b, **kw)
                logits = torch.where(use_b[:, None], lb, la)
            else:
                logits, _ = dec(self._buffers[key], *args, **kw)
            block[:, k].copy_(self._advance(st, logits))

    def _capture(self, key) -> None:
        """Capture ``_decode_k(..., key)`` on the engine's state as one
        CUDA graph. The warm-up (the kernels' libraries, cuBLAS's
        workspaces, the rope tables, first-use allocations) runs on a copy
        of the state on a side stream, so the live state is not touched;
        capture records without running."""
        st = self.state
        scratch = DecodeState(*(_clone(t) for t in st))
        scratch_block = self._block.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_k(scratch, scratch_block, key)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        del scratch, scratch_block
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            self._decode_k(st, self._block, key)
        if self._pool is None:
            self._pool = graph.pool()
        self._graphs[key] = graph
        self._captures += 1

    def _run_decode(self, key) -> None:
        if self._use_graph:
            if key not in self._graphs:
                self._capture(key)
            self._graphs[key].replay()
        else:
            self._decode_k(self.state, self._block, key)

    def _admit_device(self, pc, first_tok, slot: int, length: int,
                      budget: int, eos_id: int, active: bool,
                      page_row: np.ndarray, n_pages: int) -> None:
        """Write a batch-1 prefill cache and the slot's scalars into
        ``slot`` of the state, in place. Dense leaves take the prefill's row
        on the slot's batch row; a pool leaf takes the prefill's dense
        ``a`` rows folded into whole pages, on the slot's first
        ``n_pages`` pages of ``page_row`` (the pages past them are the
        null page, whose rows nobody reads)."""
        st = self.state
        src = _flatten(pc)
        for path, dst in _flatten(st.cache).items():
            pd = page_pool_dim(path)
            if pd is None:
                bd = cache_batch_dim(path)
                dst.select(bd, slot).copy_(src[path].select(bd, 0))
                continue
            if not n_pages:
                continue
            parts = path.split("/")
            parts[-2] = "a"                    # pool leaf <- dense leaf
            rows = src["/".join(parts)].select(cache_batch_dim(path), 0)
            M, P = page_row.shape[0], dst.shape[pd + 1]
            rows = rows.reshape(rows.shape[:pd] + (M, P)
                                + rows.shape[pd + 1:])
            ids = torch.as_tensor(page_row[:n_pages], device=self.device)
            dst.index_copy_(pd, ids, rows.narrow(pd, 0, n_pages)
                            .to(dst.dtype))
        st.tokens[slot] = first_tok
        st.positions[slot] = length
        st.active[slot] = active
        st.remaining[slot] = budget
        st.eos[slot] = eos_id

    # ------------------------------------------------------------------
    # host scheduler
    # ------------------------------------------------------------------

    def _bucket(self, S: int) -> int:
        for b in self.buckets:
            if b >= S:
                return b
        # unreachable: the bucket set ends at max_seq and submit() refuses
        # longer prompts
        raise AssertionError(f"no prefill bucket covers length {S}")

    def _run_prefill(self, bucket: int, padded, length: int):
        """The bucketed prefill; a bucket counts in
        ``stats["prefill_compiles"]`` the first time it runs."""
        if bucket not in self._compiled_buckets:
            self._compiled_buckets.add(bucket)
            self.stats["prefill_compiles"] += 1
        return self.model.prefill(self.params, padded,
                                  cache_len=self._cache_len, length=length)

    # ---- host page allocator (paged layout only) ----------------------

    def _full_blocks(self, S: int, max_new_tokens: int) -> int:
        """Pages a request can ever touch (prompt + budget, truncated at
        max_seq): what admission reserves."""
        last = min(S + max_new_tokens - 1, self.max_seq - 1)
        return last // self.page_size + 1

    def _reserved_pages(self) -> int:
        """Pages promised to in-flight requests but not yet allocated.
        Admission keeps free >= reserved, so growth in decode never
        exhausts the pool."""
        return sum(self.slot_max_blocks[i] - len(self.slot_pages[i])
                   for i, r in enumerate(self.slot_req) if r is not None)

    def _alloc_slot_pages(self, slot: int, need: int) -> None:
        pages = self.slot_pages[slot]
        while len(pages) < need:
            if not self._free_pages:
                raise RuntimeError(
                    "page pool exhausted — admission reservation invariant "
                    "violated (this is a bug)")
            pid = self._free_pages.pop()
            self._host_bt[slot, len(pages)] = pid
            pages.append(pid)
            self._bt_dirty = True

    def _release_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        if self._paged:
            self._free_pages.extend(self.slot_pages[slot])
            self.slot_pages[slot] = []
            self.slot_max_blocks[slot] = 0
            if self._host_bt[slot].any():
                self._host_bt[slot] = 0
                self._bt_dirty = True

    def _ensure_pages(self) -> None:
        """Grow every active slot's table to cover the rows the next block
        can write (on the host, between decode calls)."""
        K, P = self.decode_block, self.page_size
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            # the position the slot's next write lands on
            p0 = self.slot_len[slot] + len(req.generated) - 1
            last = min(p0 + K - 1, self.max_seq - 1)
            # never past the reservation: a slot that stops mid-block
            # freezes at a row its reservation covers
            self._alloc_slot_pages(
                slot, min(last // P + 1, self.slot_max_blocks[slot]))

    def _push_block_tables(self) -> None:
        """Copy the host tables to the device tensor the graph reads, when
        they changed. The copy is queued before the decode on the same
        stream; the staging buffer is rewritten only after the next block
        read, which waits for it."""
        if self._bt_dirty:
            self._bt_stage.copy_(torch.from_numpy(self._host_bt))
            self.state.block_tables.copy_(self._bt_stage,
                                          non_blocking=self._cuda)
            self._bt_dirty = False

    def submit(self, request: Request) -> None:
        S = request.prompt.shape[0]
        if S > self.max_seq:
            raise ValueError(
                f"prompt of {S} tokens cannot fit the engine cache "
                f"(max_seq={self.max_seq})")
        if self._paged:
            full = self._full_blocks(S, request.max_new_tokens)
            if full > self.n_pages - 1:
                raise ValueError(
                    f"request needs {full} pages but the pool only has "
                    f"{self.n_pages - 1} allocatable (n_pages={self.n_pages},"
                    f" page_size={self.page_size})")
        request.submit_t = float(self._clock())
        self.waiting.append(request)
        self._admit()

    def _admit_deadline(self, req: Request) -> Optional[float]:
        d = req.deadline_s if req.deadline_s is not None \
            else self.admit_timeout_s
        if d is None:
            return None
        return (req.submit_t or 0.0) + d

    def _shed_expired(self) -> None:
        """Reject waiting requests whose admission deadline has passed, so
        that a request the pool cannot admit in time does not hold the
        queue and its caller does not wait forever."""
        if not self.waiting:
            return
        now = float(self._clock())
        kept = []
        for req in self.waiting:
            deadline = self._admit_deadline(req)
            if deadline is not None and now > deadline:
                req.rejected = True
                req.done = True
                self.stats["rejections"] += 1
            else:
                kept.append(req)
        self.waiting = kept

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    @torch.inference_mode()
    def _admit(self) -> None:
        # free slots are found anew each time: a request that finishes at
        # admission (budget 1, EOS first, truncation) leaves its slot to
        # the next waiting one in this same pass; a deferred publish is
        # tried again each time too, so that a request admitted after the
        # pinned buffer drained takes the newest generation
        self._apply_pending()
        self._shed_expired()
        while self.waiting:
            self._apply_pending()
            free = self._free_slots()
            if not free:
                return
            full_blocks = 0
            if self._paged:
                # head-of-line page gate: reserve the request's worst case
                # of pages, or wait for in-flight requests to free some
                # (FIFO: no later, smaller request jumps the queue)
                head = self.waiting[0]
                full_blocks = self._full_blocks(head.prompt.shape[0],
                                                head.max_new_tokens)
                if (len(self._free_pages) - self._reserved_pages()
                        < full_blocks):
                    self.stats["admit_page_waits"] += 1
                    return
            slot = free[0]
            req = self.waiting.pop(0)
            S = req.prompt.shape[0]
            bucket = self._bucket(S)
            padded = torch.zeros((1, bucket), dtype=torch.long,
                                 device=self.device)
            padded[0, :S] = req.prompt.to(device=self.device,
                                          dtype=torch.long)
            logits, pc = self._run_prefill(bucket, padded, S)
            if self.sample == "greedy":
                tok = torch.argmax(logits[0], -1)
            else:
                tok = self._sample(logits, self._next_key(self.state))[0]
            t0 = int(tok)                     # one scalar an admission
            self.stats["admissions"] += 1
            self.stats["admit_transfers"] += 1
            req.generated = [t0]
            req.generation = self.generation  # pinned for its lifetime
            done0 = (req.max_new_tokens <= 1
                     or (req.eos_id is not None and t0 == req.eos_id)
                     or S >= self.max_seq - 1)
            page_row = np.zeros((self._n_blocks,), np.int64)
            n_pages = 0
            if self._paged and not done0:
                # the prompt's pages now (rows 0..S: the prompt and the
                # first decode write); growth follows in _ensure_pages
                self.slot_max_blocks[slot] = full_blocks
                self._alloc_slot_pages(
                    slot, min(S // self.page_size + 1, full_blocks))
                page_row = self._host_bt[slot].copy()
                n_pages = len(self.slot_pages[slot])
            self._admit_device(
                pc, tok, slot, S, req.max_new_tokens - 1,
                -1 if req.eos_id is None else req.eos_id, not done0,
                page_row, n_pages)
            if done0:
                req.done = True
            else:
                self.slot_req[slot] = req
                self.slot_len[slot] = S
                self.slot_buf[slot] = self._latest

    # ------------------------------------------------------------------
    # live weight publishing
    # ------------------------------------------------------------------

    def publish(self, params,
                generation: Optional[int] = None) -> Optional[bool]:
        """Queue ``params`` as the next weight generation and swap it in as
        soon as no in-flight request is pinned to the other buffer (often
        at once). In-flight requests go on decoding on their admission
        weights; new admissions take the new generation.

        Only the newest queued publish survives: one that lands before a
        deferred one applied supersedes it (``stats["publish_superseded"]``).
        Returns True when the swap happened in this call, False when it is
        deferred (it applies between decode calls once the old generation
        drains), and None when it is refused as stale (``generation`` not
        newer than what the engine serves or has queued)."""
        base = self._buf_gen[self._latest]
        if self._pending is not None:
            base = max(base, self._pending[0])   # not a queued generation
        gen = base + 1 if generation is None else int(generation)
        if gen <= self._buf_gen[self._latest]:
            return None                          # stale republish
        if self._pending is not None:
            if gen <= self._pending[0]:
                return None
            self.stats["publish_superseded"] += 1
        self.stats["publishes"] += 1
        self._pending = (gen, params)
        return self._apply_pending()

    @torch.inference_mode()
    def _own(self, j: int, src) -> None:
        """Make buffer ``j`` the engine's own tensors, copies of ``src``'s
        leaves at buffer 0's dtypes and device. Graphs captured on its old
        tensors are dropped (captured again at their next use)."""
        self._buffers[j] = tree_map(
            lambda x, r: torch.as_tensor(x).to(device=r.device,
                                               dtype=r.dtype, copy=True),
            src, self._buffers[0])
        self._owned[j] = True
        for key in (j, "dual"):
            self._graphs.pop(key, None)

    @torch.inference_mode()
    def _apply_pending(self) -> bool:
        """Copy the pending params into the other buffer unless a live
        request is still pinned to it (a buffer is written only once no
        in-flight request reads it)."""
        if self._pending is None:
            return False
        target = 1 - self._latest
        if any(r is not None and self.slot_buf[i] == target
               for i, r in enumerate(self.slot_req)):
            return False                         # deferred: buffer busy
        gen, params = self._pending
        ref = _flatten(self._buffers[self._latest])
        new = _flatten(params)
        if new.keys() != ref.keys():
            raise ValueError(
                f"published params and the engine's differ in the leaves "
                f"{sorted(new.keys() ^ ref.keys())}")
        for path, old in ref.items():
            shape = tuple(torch.as_tensor(new[path]).shape)
            if shape != tuple(old.shape):
                raise ValueError(
                    f"published params have leaf shape {shape} where the "
                    f"engine expects {tuple(old.shape)} — generation "
                    f"published from a different model config?")
        # copied at the resident dtypes into tensors the engine owns, so
        # the graphs stay valid and neither the caller's tensors (a
        # StreamingAverage folds into its own in place) nor any tensor of
        # the caller's construction params is ever written
        if self._owned[target]:
            for path, dst in _flatten(self._buffers[target]).items():
                dst.copy_(torch.as_tensor(new[path]))
        else:
            self._own(target, params)
        self._buf_gen[target] = gen
        self._latest = target
        self._pending = None
        self.stats["publish_swaps"] += 1
        return True

    # ------------------------------------------------------------------

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def cache_bytes(self) -> int:
        """Device bytes of the whole cache tree (page pools and dense
        leaves)."""
        return sum(t.numel() * t.element_size()
                   for t in _flatten(self.state.cache).values())

    @torch.inference_mode()
    def step(self) -> None:
        """One K-token decode call for all slots (a graph replay on the
        card), then one bulk read of the (B, K) block and a host replay of
        the device's stop rule.

        The host knows the buffer each active slot is pinned to, so it
        picks the single- or the dual-generation block without a device
        read: with one generation in flight it runs exactly the block of
        an engine that never published."""
        if self.active == 0:
            return
        if self._paged:
            self._ensure_pages()      # host allocation for the next K rows
            self._push_block_tables()
        bufs = {self.slot_buf[i] for i, r in enumerate(self.slot_req)
                if r is not None}
        if len(bufs) == 1:
            self._run_decode(bufs.pop())
        else:
            # the selector, as the block tables: queued before the decode,
            # its staging rewritten only after the next block read
            self._sel_stage.copy_(torch.tensor([b == 1
                                                for b in self.slot_buf]))
            self._use_b.copy_(self._sel_stage, non_blocking=self._cuda)
            self._run_decode("dual")
            self.stats["dual_decode_calls"] += 1
        self.stats["decode_calls"] += 1
        self.stats["decode_steps"] += self.decode_block
        block = self._block.cpu().tolist()        # ONE (B, K) transfer
        self.stats["decode_transfers"] += 1
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            for t in block[slot]:
                req.generated.append(t)
                n = len(req.generated)
                pos_after = self.slot_len[slot] + n - 1
                if (n >= req.max_new_tokens
                        or (req.eos_id is not None and t == req.eos_id)
                        or pos_after >= self.max_seq - 1):
                    req.done = True
                    self._release_slot(slot)      # pages back to the pool
                    break
        self._admit()

    def run(self, requests: List[Request], max_steps: int = 10_000
            ) -> Dict[int, List[int]]:
        """Serve requests to completion; returns rid -> tokens."""
        for r in requests:
            self.submit(r)
        steps = 0
        while (self.active or self.waiting) and steps < max_steps:
            self.step()
            steps += 1
        return {r.rid: r.generated for r in requests}

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, dual: bool = False) -> None:
        """Run the fixed program set once before serving: one prefill a
        bucket (each counted once in ``prefill_compiles``) and, on CUDA,
        the capture of the latest buffer's K-step graph. ``dual=True``,
        for an engine that will take live publishes: both buffers become
        the engine's own tensors (buffer 0 a copy of the caller's params,
        an unused buffer 1 a copy of buffer 0), and the graphs of both
        buffers and of the dual block are captured, so no publish or step
        captures after it."""
        for b in self.buckets:
            self._run_prefill(b, torch.zeros((1, b), dtype=torch.long,
                                             device=self.device), 1)
        keys = [self._latest]
        if dual:
            if not self._owned[0]:
                self._own(0, self._buffers[0])
            if self._buffers[1] is None:     # once made, always owned
                self._own(1, self._buffers[0])
            keys = [0, 1, "dual"]
        if self._use_graph:
            for key in keys:
                if key not in self._graphs:
                    self._capture(key)
        if self._cuda:
            torch.cuda.synchronize(self.device)
