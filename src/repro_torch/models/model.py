"""Model assembly for the dense (internlm2, qwen2.5, gemma3) and ssm
(mamba2) families.

Twin of ``repro/models/model.py``. Layers are grouped into *pattern units*
exactly as in the reference (gemma3: unit = 5 local + 1 global layers), and
params are nested dicts of tensors under the reference's key paths and
shapes: stacked ``blocks`` keep their leading ``(n_units, unit_len)`` axes,
the remainder layers form a stacked ``tail``. The reference's ``lax.scan``
over units is a Python loop here. Caches are dicts keyed by position in unit
and stacked across units on the leading axis: an attention layer's is
``{"a": {k, v}}``, a mamba layer's ``{"m": {conv, state}}``.

Training (``apply`` under autograd) rematerializes each pattern unit when
``cfg.remat`` is set, as the reference's ``jax.checkpoint`` does:
``torch.utils.checkpoint`` (non-reentrant); with ``remat_policy="dots"`` the
outputs of the weight matmuls (``aten.mm``/``aten.addmm``, which have no
batch dims) are saved and everything else is recomputed, the twin of
``dots_with_no_batch_dims_saveable``. Remat changes memory, not numbers.

Families, attention kinds and M-RoPE outside this slice are refused at
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn, mamba2
from repro_torch.models.layers import (
    apply_mlp, apply_norm, dense_init, embed_init, init_mlp, init_norm, mdot,
)

@dataclasses.dataclass(frozen=True)
class LayerKind:
    block: str = "attn"  # "attn" | "mamba"
    window: int = 0      # sliding window for attn (0 = full)


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
    """Refuse configs outside the ported slice, naming the ROADMAP item
    that will add them."""
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the hybrid family is not ported yet (ROADMAP A11: "
            f"zamba2's shared attention block at head_dim {cfg.head_dim}, "
            f"which the flash kernels do not take yet)")
    if cfg.family not in ("dense", "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP "
            f"A11 other families; A9 for the cnn)")
    if cfg.family == "ssm":
        return
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: attention {cfg.attention!r} is not ported yet "
            f"(ROADMAP A11, MLA)")
    if cfg.mrope_sections:
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE is not ported yet (ROADMAP A11, qwen2-vl)")


class Model:
    """Functional model: init/apply/prefill/decode."""

    def __init__(self, cfg: ModelConfig):
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.unit_kinds, self.n_units, self.tail_kinds = self._plan(cfg)

    # ------------------------------------------------------------------
    # layer plan
    # ------------------------------------------------------------------

    @staticmethod
    def _plan(cfg: ModelConfig) -> Tuple[List[LayerKind], int, List[LayerKind]]:
        if cfg.family == "ssm":
            unit = [LayerKind("mamba")]
        elif cfg.local_global_pattern != (0, 0):
            loc, glob = cfg.local_global_pattern
            unit = ([LayerKind(window=cfg.sliding_window)] * loc
                    + [LayerKind()] * glob)
        else:
            unit = [LayerKind(window=cfg.sliding_window)]
        n_units, rem = divmod(cfg.n_layers, len(unit))
        return unit, n_units, unit[:rem]

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------

    def _init_blocks(self, gen: torch.Generator, lead: Tuple[int, ...]):
        """Params of ``prod(lead)`` blocks, stacked on the ``lead`` axes
        (every block of a ported family has the same kind of params)."""
        cfg = self.cfg
        if self.unit_kinds[0].block == "mamba":
            return {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device, lead),
                    "mamba": mamba2.init_mamba(gen, cfg, lead)}
        return {"ln1": init_norm(cfg.d_model, cfg.norm, gen.device, lead),
                "ln2": init_norm(cfg.d_model, cfg.norm, gen.device, lead),
                "attn": attn.init_gqa(gen, cfg, lead),
                "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, lead)}

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
        return params

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------

    def _block_full(self, p, h, kind: LayerKind, positions, mode: str):
        """Returns (h, cache); cache is {} unless mode == "prefill"."""
        cfg = self.cfg
        cache = {}
        x = apply_norm(p["ln1"], h, cfg.norm, cfg.norm_eps)
        if kind.block == "mamba":
            if mode == "prefill":
                y, cache["m"] = mamba2.mamba_forward(p["mamba"], x, cfg,
                                                     return_cache=True)
            else:
                y = mamba2.mamba_forward(p["mamba"], x, cfg)
            return h + y, cache
        if mode == "prefill":
            y, cache["a"] = attn.gqa_forward(
                p["attn"], x, cfg, positions=positions, window=kind.window,
                return_cache=True)
        else:
            y = attn.gqa_forward(p["attn"], x, cfg, positions=positions,
                                 window=kind.window)
        h = h + y
        x = apply_norm(p["ln2"], h, cfg.norm, cfg.norm_eps)
        return h + apply_mlp(p["mlp"], x, cfg.act, self.dtype), cache

    def _block_decode(self, p, h, kind: LayerKind, cache, pos):
        cfg = self.cfg
        x = apply_norm(p["ln1"], h, cfg.norm, cfg.norm_eps)
        if kind.block == "mamba":
            y, mc = mamba2.mamba_decode(p["mamba"], x, cache["m"], cfg)
            return h + y, {"m": mc}
        y, ac = attn.gqa_decode(p["attn"], x, cache["a"], pos, cfg,
                                window=kind.window)
        h = h + y
        x = apply_norm(p["ln2"], h, cfg.norm, cfg.norm_eps)
        return h + apply_mlp(p["mlp"], x, cfg.act, self.dtype), {"a": ac}

    def _units(self, params):
        """Each pattern unit's params (leading axis unit_len)."""
        if "blocks" not in params or not self.n_units:
            return []
        return _tree_unbind(params["blocks"], self.n_units)

    def _tail(self, params):
        return (_tree_unbind(params["tail"], len(self.tail_kinds))
                if self.tail_kinds else [])

    def _layers(self, params):
        """(unit index or None for the tail, position, kind, block params)
        for every layer in order."""
        for u, unit_p in enumerate(self._units(params)):
            layers = _tree_unbind(unit_p, len(self.unit_kinds))
            for i, kind in enumerate(self.unit_kinds):
                yield u, i, kind, layers[i]
        for i, (kind, p) in enumerate(zip(self.tail_kinds,
                                          self._tail(params))):
            yield None, i, kind, p

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------

    def _embed(self, params, tokens):
        # a gather then a cast gives the values of the reference's cast
        # then gather, without casting the whole table
        return params["embed"]["table"][tokens].to(self.dtype)

    def _default_positions(self, B, S, device):
        return torch.arange(S, device=device)[None, :].expand(B, S)

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

    def apply(self, params, tokens):
        """Full-sequence forward. Returns (logits, aux_loss)."""
        cfg = self.cfg
        B, S = tokens.shape
        positions = self._default_positions(B, S, tokens.device)
        h = self._embed(params, tokens)

        def unit(h, unit_p):
            layers = _tree_unbind(unit_p, len(self.unit_kinds))
            for p, kind in zip(layers, self.unit_kinds):
                h, _ = self._block_full(p, h, kind, positions, "train")
            return h

        for unit_p in self._units(params):
            h = self._remat(unit, h, unit_p) if cfg.remat else unit(h, unit_p)
        for kind, p in zip(self.tail_kinds, self._tail(params)):
            h, _ = self._block_full(p, h, kind, positions, "train")
        h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        return self._head(params, h), aux

    def prefill(self, params, tokens, *, cache_len: Optional[int] = None):
        """Returns (last-token logits (B, vocab), cache) with caches padded
        to ``cache_len`` (window layers: to min(cache_len, window))."""
        cfg = self.cfg
        B, S = tokens.shape
        cache_len = cache_len or S
        positions = self._default_positions(B, S, tokens.device)
        h = self._embed(params, tokens)

        def pad_cache(c, kind: LayerKind):
            if kind.block == "mamba":
                return c
            L = c["a"]["k"].shape[1]
            tgt = min(cache_len, kind.window) if kind.window > 0 else cache_len
            if L < tgt:
                c = {"a": {kk: torch.cat(
                    [vv, vv.new_zeros((vv.shape[0], tgt - L) + vv.shape[2:])],
                    dim=1) for kk, vv in c["a"].items()}}
            return c

        per_unit: List[Dict[str, Any]] = [{} for _ in range(self.n_units)]
        cache: Dict[str, Any] = {}
        for u, i, kind, p in self._layers(params):
            h, c = self._block_full(p, h, kind, positions, "prefill")
            if u is None:
                cache[f"t{i}"] = pad_cache(c, kind)
            else:
                per_unit[u][str(i)] = pad_cache(c, kind)
        if "blocks" in params and self.n_units:
            cache["units"] = _tree_stack(per_unit)
        h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        logits = self._head(params, h[:, -1:])[:, 0]
        return logits, cache

    def decode(self, params, cache, token, pos):
        """One decode step. token: (B,1) long; pos: a Python int (absolute
        position for the batch) or a (B,) long tensor of per-request
        positions (continuous batching). Returns (logits (B, vocab),
        new_cache); the input cache is left as it was."""
        cfg = self.cfg
        h = self._embed(params, token)
        per_unit: List[Dict[str, Any]] = [{} for _ in range(self.n_units)]
        new_cache: Dict[str, Any] = {}
        for u, i, kind, p in self._layers(params):
            if u is None:
                h, new_cache[f"t{i}"] = self._block_decode(
                    p, h, kind, cache[f"t{i}"], pos)
            else:
                h, per_unit[u][str(i)] = self._block_decode(
                    p, h, kind, _tree_index(cache["units"], u)[str(i)], pos)
        if "units" in cache:
            new_cache["units"] = _tree_stack(per_unit)
        h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
        return self._head(params, h)[:, 0], new_cache

    def empty_cache(self, batch: int, cache_len: int, device):
        """Zero-initialized cache."""
        cfg = self.cfg

        def block_cache(kind: LayerKind, lead=()):
            if kind.block == "mamba":
                key = "m"
                c = mamba2.mamba_empty_cache(cfg, batch, self.dtype, device)
            else:
                key = "a"
                c = attn.gqa_empty_cache(cfg, batch, cache_len, kind.window,
                                         self.dtype, device)
            return {key: {k: v.expand(lead + v.shape).clone()
                          for k, v in c.items()}}

        cache: Dict[str, Any] = {}
        if self.n_units:
            cache["units"] = {str(i): block_cache(k, (self.n_units,))
                              for i, k in enumerate(self.unit_kinds)}
        for i, kind in enumerate(self.tail_kinds):
            cache[f"t{i}"] = block_cache(kind)
        return cache
