"""Model assembly for the dense (internlm2, qwen2.5, gemma3, minicpm3), moe
(granite-moe, qwen3-moe, deepseek-v2-lite), ssm (mamba2), hybrid (zamba2),
audio (whisper) and vlm (qwen2-vl) families, with GQA or MLA attention.

Twin of ``repro/models/model.py``. Layers are grouped into *pattern units*
exactly as in the reference (gemma3: unit = 5 local + 1 global layers), and
params are nested dicts of tensors under the reference's key paths and
shapes: stacked ``blocks`` keep their leading ``(n_units, unit_len)`` axes,
the remainder layers form a stacked ``tail``. The reference's ``lax.scan``
over units is a Python loop here. Caches are dicts keyed by position in unit
and stacked across units on the leading axis: an attention layer's is
``{"a": {k, v}}`` (MLA's the latent ``{"a": {c_kv, k_rope}}``), a mamba
layer's ``{"m": {conv, state}}``. ``apply`` returns the MoE layers' summed
router aux loss beside the logits, as the reference's scan carries it.

The hybrid family (zamba2): a pattern unit is ``shared_attn_every`` mamba
layers, and ONE attention block with its MLP, unstacked at
``params["shared"]``, runs before each unit (not before the tail's
layers). Each application keeps its own KV cache, under ``"shared"`` in its
unit's cache; in training it is recomputed with its unit under remat, and
its gradient is the sum over its applications.

The audio family (whisper): an encoder stack at ``params["encoder"]``
(``blocks`` stacked on one leading axis, and a ``norm``) runs
non-causal self attention over stub frame embeddings (B, encoder_seq,
d_model) plus sinusoidal positions; every decoder layer adds, after its
causal self attention, cross attention (``lnx``, ``xattn``) over the
encoder output. The decoder has no rope: sinusoidal positions are added to
its token embeddings. ``apply`` and ``prefill`` take the ``frames``; the
prefill caches each layer's encoder K/V under ``"x"``, which decode reads
and never changes. As in the reference, the encoder is not
rematerialized.

The vlm family (qwen2-vl): M-RoPE, whose rope positions are (B, 3, S)
(temporal, height, width; by default the token index in all three), each
component rotating its own section of the half-dim
(``cfg.mrope_sections``). The vision encoder is a stub, as in the
reference: ``vision_embeds`` (B, n_vision_tokens, d_model), patch
embeddings cast to the compute dtype, take the place of the first
n_vision_tokens token embeddings in ``apply`` and ``prefill``. Decode
takes text tokens only; its rope positions are ``pos`` in all three
components unless ``positions`` (B, 3, 1) are given.

Training (``apply`` under autograd) rematerializes each pattern unit when
``cfg.remat`` is set, as the reference's ``jax.checkpoint`` does:
``torch.utils.checkpoint`` (non-reentrant); with ``remat_policy="dots"`` the
outputs of the weight matmuls (``aten.mm``/``aten.addmm``, which have no
batch dims) are saved and everything else is recomputed, the twin of
``dots_with_no_batch_dims_saveable``. Remat changes memory, not numbers.

Serving with the compiled engine (``serve/compiled.py``): ``prefill(...,
length=)`` makes a right-padded prompt bucket exact (the logits of token
``length-1``, window slots and SSM states from the real tokens only);
``empty_cache(..., page_pool=)`` puts every pageable layer's K/V
(full-attention GQA, ``pageable``) in a ``"p"`` page pool beside the dense
``"a"``/``"m"`` leaves of the others, under the reference's key paths;
``decode(..., block_tables=)`` reads and writes those pools, and
``decode(..., inplace=True)`` writes the new rows into the cache it is
given (the engine's own buffers) instead of returning a new tree.

An attention kind other than GQA and MLA is refused at construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn, mamba2, moe
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_mlp, init_norm, mdot,
    sinusoidal_embedding,
)


@dataclasses.dataclass(frozen=True)
class LayerKind:
    block: str = "attn"    # "attn" | "mamba"
    window: int = 0        # sliding window for attn (0 = full)
    use_moe: bool = False  # MoE FFN in place of the MLP
    cross: bool = False    # adds cross attention (whisper's decoder)


# the hybrid family's shared attention block: full attention with its MLP
SHARED = LayerKind()


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_index(tree, i):
    return _tree_map(lambda a: a[i], tree)


def _tree_unbind(tree, n: int):
    """The ``n`` slices of a stacked tree along its leading axis. Unlike
    ``n`` index views, whose backward writes each slice's gradient into a
    zero tensor of the whole stacked size, ``unbind``'s backward stacks the
    ``n`` gradients once."""
    if isinstance(tree, dict):
        parts = {k: _tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _tree_stack(trees, dim=0):
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees], dim) for k in trees[0]}
    return torch.stack(trees, dim=dim)


def _save_dots_policy(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _save_dots_context():
    return ckpt.create_selective_checkpoint_contexts(_save_dots_policy)


def check_supported(cfg: ModelConfig) -> None:
    """Refuse configs the Model does not take: the cnn family (a
    functional model of its own) and attention kinds other than GQA and
    MLA."""
    if cfg.family == "cnn":
        raise NotImplementedError(
            f"{cfg.name}: the cnn family is not a Model: it is the functional "
            f"repro_torch.models.cnn (init_cnn, apply_cnn), as in the "
            f"reference")
    if cfg.family == "ssm":
        return
    if cfg.attention not in ("gqa", "mla"):
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attention!r} is not ported: the "
            f"port takes 'gqa' and 'mla'")


class Model:
    """Functional model: init/apply/prefill/decode."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.unit_kinds, self.n_units, self.tail_kinds = self._plan(cfg)
        self.use_rope = cfg.family != "audio"

    # ------------------------------------------------------------------
    # layer plan
    # ------------------------------------------------------------------

    @staticmethod
    def _plan(cfg: ModelConfig) -> Tuple[List[LayerKind], int, List[LayerKind]]:
        if cfg.family == "ssm":
            unit = [LayerKind("mamba")]
        elif cfg.family == "hybrid":
            unit = [LayerKind("mamba")] * cfg.shared_attn_every
        elif cfg.family == "audio":
            unit = [LayerKind(cross=True)]
        elif cfg.local_global_pattern != (0, 0):
            loc, glob = cfg.local_global_pattern
            unit = ([LayerKind(window=cfg.sliding_window)] * loc
                    + [LayerKind()] * glob)
        else:
            unit = [LayerKind(window=cfg.sliding_window)]
        if cfg.family == "moe":
            unit = [dataclasses.replace(k, use_moe=True) for k in unit]
        n_units, rem = divmod(cfg.n_layers, len(unit))
        return unit, n_units, unit[:rem]

    # ------------------------------------------------------------------
    # paged-cache capability
    # ------------------------------------------------------------------

    def pageable(self, kind: LayerKind) -> bool:
        """Whether a layer's KV cache can live in a paged pool:
        full-attention GQA self attention only. Window caches are already
        O(window), SSM states O(1), and MLA and cross caches keep their
        dense layout."""
        return (kind.block == "attn" and kind.window == 0
                and not kind.cross and self.cfg.attention == "gqa")

    @property
    def has_pageable(self) -> bool:
        """True if any layer can use a paged pool (the compiled engine's
        ``kv_layout="auto"`` is paged exactly then); the hybrid's shared
        block counts."""
        kinds = list(self.unit_kinds) + list(self.tail_kinds)
        if self.cfg.family == "hybrid":
            kinds.append(SHARED)
        return any(self.pageable(k) for k in kinds)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def _init_blocks(self, gen: torch.Generator, lead: Tuple[int, ...],
                     kind: Optional[LayerKind] = None):
        """Params of ``prod(lead)`` blocks of ``kind`` (the unit's: every
        block of a ported family's units has the same kind of params),
        stacked on the ``lead`` axes."""
        cfg = self.cfg
        kind = kind or self.unit_kinds[0]
        if kind.block == "mamba":
            return {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device, lead),
                    "mamba": mamba2.init_mamba(gen, cfg, lead)}
        p = {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device, lead),
             "ln2": init_norm(cfg.d_model, cfg.norm, gen.device, lead),
             "attn": (attn.init_mla(gen, cfg, lead) if cfg.attention == "mla"
                      else attn.init_gqa(gen, cfg, lead))}
        if kind.cross and cfg.is_encoder_decoder:
            p["lnx"] = init_norm(cfg.d_model, cfg.norm, gen.device, lead)
            p["xattn"] = attn.init_gqa(gen, cfg, lead, cross=True)
        if kind.use_moe:
            p["moe"] = moe.init_moe(gen, cfg, lead)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, lead)
        return p

    def init(self, gen: torch.Generator) -> Dict[str, Any]:
        """Random params on ``gen.device`` (same distributions as the
        reference; the numbers differ from JAX's for the same seed)."""
        cfg = self.cfg
        params: Dict[str, Any] = {
            "embed": {"table": embed_init(gen, (cfg.vocab_size, cfg.d_model))},
            "final_norm": init_norm(cfg.d_model, cfg.norm, gen.device),
        }
        if not cfg.tie_embeddings:
            params["head"] = {
                "w": dense_init(gen, (cfg.d_model, cfg.vocab_size))}
        if self.n_units:
            params["blocks"] = self._init_blocks(
                gen, (self.n_units, len(self.unit_kinds)))
        if self.tail_kinds:
            params["tail"] = self._init_blocks(gen, (len(self.tail_kinds),))
        if cfg.family == "hybrid":
            params["shared"] = self._init_blocks(gen, (), SHARED)
        if cfg.is_encoder_decoder:
            params["encoder"] = {
                "blocks": self._init_blocks(gen, (cfg.n_encoder_layers,),
                                            LayerKind()),
                "norm": init_norm(cfg.d_model, cfg.norm, gen.device)}
        return params

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------

    def _ffn(self, p, x, kind: LayerKind):
        """(out, aux): the MoE FFN and its router aux loss, or the MLP and
        None."""
        if kind.use_moe:
            return moe.moe_forward(p["moe"], x, self.cfg)
        return apply_mlp(p["mlp"], x, self.cfg.act, self.dtype), None

    def _block_full(self, p, h, kind: LayerKind, positions, mode: str,
                    enc_out=None, length=None):
        """Returns (h, cache, aux); cache is {} unless mode == "prefill",
        aux is None unless the layer is MoE. mode "encode" is the audio
        encoder's non-causal self attention; ``enc_out``: the encoder
        output that a cross layer attends to; ``length``: the real tokens
        of a right-padded prefill bucket (see ``prefill``)."""
        cfg = self.cfg
        cache = {}
        x = apply_norm(p["ln1"], h, cfg.norm, cfg.norm_eps)
        if kind.block == "mamba":
            if mode == "prefill":
                y, cache["m"] = mamba2.mamba_forward(
                    p["mamba"], x, cfg, return_cache=True, length=length)
            else:
                y = mamba2.mamba_forward(p["mamba"], x, cfg)
            return h + y, cache, None
        prefill = mode == "prefill"
        if cfg.attention == "mla":
            y = attn.mla_forward(p["attn"], x, cfg, positions=positions,
                                 return_cache=prefill)
        else:
            y = attn.gqa_forward(
                p["attn"], x, cfg,
                positions=positions if self.use_rope else None,
                window=kind.window, causal=mode != "encode",
                return_cache=prefill, length=length)
        if prefill:
            y, cache["a"] = y
        h = h + y
        if kind.cross and enc_out is not None:
            x = apply_norm(p["lnx"], h, cfg.norm, cfg.norm_eps)
            y = attn.gqa_forward(p["xattn"], x, cfg, cross_x=enc_out,
                                 return_cache=prefill)
            if prefill:
                y, cache["x"] = y
            h = h + y
        x = apply_norm(p["ln2"], h, cfg.norm, cfg.norm_eps)
        y, aux = self._ffn(p, x, kind)
        return h + y, cache, aux

    def _block_decode(self, p, h, kind: LayerKind, cache, pos, positions,
                      block_tables=None, inplace: bool = False,
                      write_mask=None):
        cfg = self.cfg
        x = apply_norm(p["ln1"], h, cfg.norm, cfg.norm_eps)
        wm = dict(inplace=inplace, write_mask=write_mask)
        if kind.block == "mamba":
            y, mc = mamba2.mamba_decode(p["mamba"], x, cache["m"], cfg, **wm)
            return h + y, {"m": mc}
        if "p" in cache:          # the paged pool, read through the tables
            key = "p"
            y, ac = attn.gqa_decode_paged(
                p["attn"], x, cache["p"], pos, block_tables, cfg,
                positions=positions, use_rope=self.use_rope, **wm)
        elif cfg.attention == "mla":
            key = "a"
            y, ac = attn.mla_decode(p["attn"], x, cache["a"], pos, cfg,
                                    positions=positions, **wm)
        else:
            key = "a"
            y, ac = attn.gqa_decode(p["attn"], x, cache["a"], pos, cfg,
                                    window=kind.window, positions=positions,
                                    use_rope=self.use_rope, **wm)
        h = h + y
        new_cache = {key: ac}
        if kind.cross and "x" in cache:
            x = apply_norm(p["lnx"], h, cfg.norm, cfg.norm_eps)
            y, new_cache["x"] = attn.gqa_decode(p["xattn"], x, cache["x"],
                                                pos, cfg, cross=True)
            h = h + y
        x = apply_norm(p["ln2"], h, cfg.norm, cfg.norm_eps)
        return h + self._ffn(p, x, kind)[0], new_cache

    def _units(self, params):
        """Each pattern unit's params (leading axis unit_len)."""
        if "blocks" not in params or not self.n_units:
            return []
        return _tree_unbind(params["blocks"], self.n_units)

    def _tail(self, params):
        return (_tree_unbind(params["tail"], len(self.tail_kinds))
                if self.tail_kinds else [])

    def _layers(self, params):
        """(unit index or None for the tail, cache key, kind, block params)
        for every block in order: a unit's layers under keys "0", "1", ...,
        preceded in the hybrid family by the shared block under "shared";
        the tail's under "t0", "t1", ..."""
        hybrid = self.cfg.family == "hybrid"
        for u, unit_p in enumerate(self._units(params)):
            if hybrid:
                yield u, "shared", SHARED, params["shared"]
            layers = _tree_unbind(unit_p, len(self.unit_kinds))
            for i, kind in enumerate(self.unit_kinds):
                yield u, str(i), kind, layers[i]
        for i, (kind, p) in enumerate(zip(self.tail_kinds,
                                          self._tail(params))):
            yield None, f"t{i}", kind, p

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------

    def _embed(self, params, tokens, positions, vision_embeds=None):
        """Token embeddings; in the vlm family ``vision_embeds`` (B, nv,
        d_model), cast to the compute dtype, replace the first nv of them;
        the audio decoder adds sinusoidal positions (``positions``: (B,
        S))."""
        # a gather then a cast gives the values of the reference's cast
        # then gather, without casting the whole table
        h = params["embed"]["table"][tokens].to(self.dtype)
        if self.cfg.family == "vlm" and vision_embeds is not None:
            nv, S = vision_embeds.shape[1], tokens.shape[1]
            if nv > S:
                # the reference's concatenation would return nv > S
                # embeddings, which its positions do not cover
                raise ValueError(
                    f"{self.cfg.name}: {nv} vision embeddings do not fit a "
                    f"sequence of {S} tokens: the prompt must hold at least "
                    f"n_vision_tokens = {nv} tokens")
            h = torch.cat([vision_embeds.to(self.dtype), h[:, nv:]], dim=1)
        if self.cfg.family == "audio":
            h = h + sinusoidal_embedding(positions,
                                         self.cfg.d_model).to(self.dtype)
        return h

    def _default_positions(self, B, S, device):
        """(B, S) token indices; (B, 3, S), the index in each component,
        under M-RoPE."""
        pos = torch.arange(S, device=device)[None, :].expand(B, S)
        if self.cfg.mrope_sections:
            pos = pos[:, None, :].expand(B, 3, S)
        return pos

    def _encode(self, params, frames):
        """The audio encoder on stub frame embeddings (B, encoder_seq,
        d_model): sinusoidal positions, the stacked blocks (non-causal
        self attention), the final norm."""
        cfg = self.cfg
        if frames is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder model needs "
                             f"frames (B, encoder_seq, d_model)")
        h = frames.to(self.dtype)
        h = h + sinusoidal_embedding(
            torch.arange(h.shape[1], device=h.device),
            cfg.d_model).to(self.dtype)
        enc = params["encoder"]
        for p in _tree_unbind(enc["blocks"], cfg.n_encoder_layers):
            h = self._block_full(p, h, LayerKind(), None, "encode")[0]
        return apply_norm(enc["norm"], h, cfg.norm, cfg.norm_eps)

    def _head(self, params, h):
        if self.cfg.tie_embeddings:
            return mdot(h, params["embed"]["table"].T, self.dtype)
        return mdot(h, params["head"]["w"], self.dtype)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def _remat(self, fn, *args):
        """``fn(*args)`` under activation checkpointing (see the module
        docstring), or plainly when nothing needs a gradient."""
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if self.cfg.remat_policy == "dots":
            kw["context_fn"] = _save_dots_context
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)

    def apply(self, params, tokens, *, positions=None, vision_embeds=None,
              frames=None):
        """Full-sequence forward. Returns (logits, aux_loss): the sum of the
        MoE layers' router aux losses (0 without MoE layers).
        ``positions``: (B, S), or (B, 3, S) under M-RoPE; the token indices
        by default. ``vision_embeds``: the vlm family's stub patch
        embeddings (B, n_vision_tokens, d_model). ``frames``: the audio
        family's encoder input (B, encoder_seq, d_model)."""
        cfg = self.cfg
        B, S = tokens.shape
        if positions is None:
            positions = self._default_positions(B, S, tokens.device)
        enc_out = (self._encode(params, frames) if cfg.is_encoder_decoder
                   else None)
        h = self._embed(params, tokens, positions, vision_embeds)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)

        def layer(h, aux, p, kind, enc_out):
            h, _, a = self._block_full(p, h, kind, positions, "train",
                                       enc_out)
            return h, aux if a is None else aux + a

        def unit(h, aux, unit_p, shared_p, enc_out):
            if shared_p is not None:      # the hybrid's shared block
                h, aux = layer(h, aux, shared_p, SHARED, enc_out)
            layers = _tree_unbind(unit_p, len(self.unit_kinds))
            for p, kind in zip(layers, self.unit_kinds):
                h, aux = layer(h, aux, p, kind, enc_out)
            return h, aux

        shared_p = params.get("shared")
        for unit_p in self._units(params):
            args = (h, aux, unit_p, shared_p, enc_out)
            h, aux = (self._remat(unit, *args) if cfg.remat
                      else unit(*args))
        for kind, p in zip(self.tail_kinds, self._tail(params)):
            h, aux = layer(h, aux, p, kind, enc_out)
        h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        return self._head(params, h), aux

    def prefill(self, params, tokens, *, cache_len: Optional[int] = None,
                positions=None, vision_embeds=None, frames=None,
                length=None):
        """Returns (last-token logits (B, vocab), cache) with caches padded
        to ``cache_len`` (window layers: to min(cache_len, window); a cross
        layer's encoder K/V as they are). ``positions``, ``vision_embeds``
        and ``frames``: as for ``apply``.

        ``length``: the count of real tokens (an int) when ``tokens`` is
        right-padded to a prefill bucket. The logits are then
        those of token ``length-1``, window caches take their slots from
        real positions, and SSM states are the states after ``length``
        tokens (dt is zeroed on the padding). Full-length K/V rows past
        ``length`` hold the padding's values, which decode never attends:
        a step writes position p before it attends, and the mask admits
        rows <= p only."""
        cfg = self.cfg
        B, S = tokens.shape
        cache_len = cache_len or S
        if positions is None:
            positions = self._default_positions(B, S, tokens.device)
        enc_out = (self._encode(params, frames) if cfg.is_encoder_decoder
                   else None)
        h = self._embed(params, tokens, positions, vision_embeds)

        def pad_cache(c, kind: LayerKind):
            if kind.block == "mamba":
                return c
            if "c_kv" in c["a"]:                   # MLA's latent cache
                L, tgt = c["a"]["c_kv"].shape[1], cache_len
            else:
                L = c["a"]["k"].shape[1]
                tgt = (min(cache_len, kind.window) if kind.window > 0
                       else cache_len)
            if L < tgt:
                c = dict(c, a={kk: torch.cat(
                    [vv, vv.new_zeros((vv.shape[0], tgt - L) + vv.shape[2:])],
                    dim=1) for kk, vv in c["a"].items()})
            return c

        per_unit: List[Dict[str, Any]] = [{} for _ in range(self.n_units)]
        cache: Dict[str, Any] = {}
        for u, key, kind, p in self._layers(params):
            h, c, _ = self._block_full(p, h, kind, positions, "prefill",
                                       enc_out, length)
            (cache if u is None else per_unit[u])[key] = pad_cache(c, kind)
        if "blocks" in params and self.n_units:
            cache["units"] = _tree_stack(per_unit)
        h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        h_last = h[:, -1:] if length is None else h[:, length - 1:length]
        logits = self._head(params, h_last)[:, 0]
        return logits, cache

    def decode(self, params, cache, token, pos, *, positions=None,
               block_tables=None, inplace: bool = False, write_mask=None):
        """One decode step. token: (B,1) long; pos: a Python int (absolute
        position for the batch) or a (B,) long tensor of per-request
        positions (continuous batching). ``positions``: the token's rope
        positions, (B, 1) or (B, 3, 1) under M-RoPE; ``pos`` in every
        component by default. ``block_tables``: (B, M) long page ids a
        slot, needed where the cache holds paged (``"p"``) pools. Returns
        (logits (B, vocab), new_cache); the input cache is left as it was,
        unless ``inplace``: then every layer writes its new row (or SSM
        state) into ``cache``, which is returned, so a step copies no
        cache and allocates nothing that outlives it. ``write_mask``: a
        (B,) bool tensor; only the slots it marks write their rows and SSM
        states, the others keep theirs (the compiled engine decodes two
        weight generations on one cache so)."""
        cfg = self.cfg
        B = token.shape[0]
        if positions is None:
            positions = (pos[:, None] if isinstance(pos, torch.Tensor)
                         else torch.full((B, 1), pos, device=token.device))
            if cfg.mrope_sections:
                positions = positions[:, None, :].expand(B, 3, 1)
        h = self._embed(params, token, positions)
        per_unit: List[Dict[str, Any]] = [{} for _ in range(self.n_units)]
        new_cache: Dict[str, Any] = {}
        for u, key, kind, p in self._layers(params):
            # a unit's cache is a view into the stacked leaves
            c = cache[key] if u is None else _tree_index(cache["units"],
                                                          u)[key]
            h, c = self._block_decode(p, h, kind, c, pos, positions,
                                      block_tables, inplace, write_mask)
            (new_cache if u is None else per_unit[u])[key] = c
        if inplace:
            new_cache = cache
        elif "units" in cache:
            new_cache["units"] = _tree_stack(per_unit)
        h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        return self._head(params, h)[:, 0], new_cache

    def empty_cache(self, batch: int, cache_len: int, device, *,
                    page_pool=None):
        """Zero-initialized cache. ``page_pool``: ``(n_pages, page_size)``;
        pageable layers (see ``pageable``) then hold a ``"p"`` page pool
        shared by all slots in place of a per-slot ``"a"`` cache, and the
        others keep their dense layout in the same tree."""
        cfg = self.cfg

        def block_cache(kind: LayerKind, lead=()):
            if kind.block == "mamba":
                key = "m"
                c = mamba2.mamba_empty_cache(cfg, batch, self.dtype, device)
            elif page_pool is not None and self.pageable(kind):
                key = "p"
                c = attn.gqa_empty_page_pool(cfg, *page_pool, self.dtype,
                                             device)
            elif cfg.attention == "mla":
                key = "a"
                c = attn.mla_empty_cache(cfg, batch, cache_len, self.dtype,
                                         device)
            else:
                key = "a"
                c = attn.gqa_empty_cache(cfg, batch, cache_len, kind.window,
                                         self.dtype, device)
            out = {key: c}
            if kind.cross and cfg.is_encoder_decoder:   # encoder K/V
                z = torch.zeros((batch, cfg.encoder_seq, cfg.n_kv_heads,
                                 cfg.head_dim), dtype=self.dtype,
                                device=device)
                out["x"] = {"k": z, "v": z.clone()}
            return {key: {k: v.expand(lead + v.shape).clone()
                          for k, v in c.items()} for key, c in out.items()}

        cache: Dict[str, Any] = {}
        if self.n_units:
            cache["units"] = {str(i): block_cache(k, (self.n_units,))
                              for i, k in enumerate(self.unit_kinds)}
            if cfg.family == "hybrid":
                cache["units"]["shared"] = block_cache(SHARED,
                                                       (self.n_units,))
        for i, kind in enumerate(self.tail_kinds):
            cache[f"t{i}"] = block_cache(kind)
        return cache
