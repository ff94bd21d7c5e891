"""Model stacks of every family (``repro/models/transformer.py``): dense,
moe, vlm, audio (one transformer layer stack, with the MoE sublayer in
place of the MLP for moe), ssm (RWKV6) and hybrid (Zamba2), with the
reference's functional API::

    init(seed, device)              → params (nested dict, layer-stacked)
    forward(params, batch)          → (logits, aux)           [prefill]
    prefill(params, batch)          → last-position logits (B, vocab)
    loss(params, batch)             → (scalar, metrics)        [training]
    init_decode_state(batch, ctx)   → DecodeState
    decode_step(params, state, tok) → (logits, DecodeState)   [serving]

The reference's ``lax.scan`` over stacked layer weights is a Python loop
over the stacked axis.  The hybrid stack is stacked twice, (sites,
attn_every, ...): each site runs ``attn_every`` Mamba2 layers, then the one
*shared* transformer block (one set of weights at every site, a KV cache
per site).  Decode states are updated in place.  The VLM prefills
``[projected patches; text]`` and decodes text only; the audio encoder
takes frame embeddings plus a sinusoidal table and has no decode step.

Training: under grad, with ``cfg.remat``, each layer (each site of the
hybrid) runs under ``torch.utils.checkpoint`` and is recomputed in the
backward, as the reference wraps its scan bodies in ``jax.checkpoint``; the
stacked weights are split into layers with one ``unbind`` per leaf, whose
gradient is one ``stack``.  ``loss`` takes the cross-entropy in sequence
chunks, each checkpointed, so the (B, S, V) f32 logits are never all live.

Tensor-parallel compute: ``Model(cfg, tp)`` with a
``distributed.tp.ModelParallel`` computes on the rank's blocks of the
leaves the ruleset splits over ``model`` (``heads``, ``kv_heads``,
``mlp``, ``expert``, ``vocab``), each layer deciding from its leaves'
shapes what is split: attention and the MLP / MoE as their modules say,
the embedding vocab-parallel, the head on the rank's vocab columns (the
logits of ``prefill``/``decode_step``/``forward`` gathered over ``model``),
the loss a vocab-parallel cross-entropy; RWKV6 and Mamba2 on their heads
and ``mlp`` columns (``rwkv6.py``, ``mamba2.py``), Zamba2's shared block as
a dense layer.  The decode state is built at the rank's shapes by
``init_decode_state(..., mesh=, rules=)``.

FSDP: ``Model(cfg, tp, feed)`` with a ``distributed.fsdp.Feed`` draws
every leaf through the feed, unit by unit (the embedding, the projector,
each layer or site, the shared block, the head): ``params`` are then the
rank's blocks, and each unit is gathered over the data axes where it is
used (``_run``, ``_unit``).  Without a feed the layers are views of the
stacked leaves, as above.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import layout
from repro_torch.distributed.sharding import decode_state_spec
from repro_torch.distributed.tp import ModelParallel, enter, gather_last, leave, split_by
from . import layers as L
from .attention import (
    KVCache,
    attention_block,
    attention_specs,
    cache_write_slot,
    decode_attention_block,
    init_kv_cache,
)
from .mamba2 import SSMState, init_ssm_state, mamba2_block, mamba2_decode_step, mamba2_specs
from .moe import moe_block, moe_specs
from .params import ParamSpec, axes_tree, count_params, count_params_from_specs, init_params, \
    resolve_dtype, stack_specs
from .rwkv6 import RWKVState, init_rwkv_state, rwkv6_block, rwkv6_decode_step, rwkv6_specs

__all__ = ["Model", "DecodeState"]

# the families whose layers are one attention block and one MLP / MoE
TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")


class DecodeState(NamedTuple):
    """The reference's union decode state; a family's unused fields are
    None (the reference's are empty pytrees)."""
    kv: Optional[KVCache] = None
    ssm: Optional[SSMState] = None
    rwkv: Optional[RWKVState] = None


def _decode_window(cfg: ModelConfig, capacity: int) -> Optional[int]:
    """Window to apply during decode, derived from the cache capacity: a
    cache whose capacity equals the arch's SWA window or the long-context
    window is a ring buffer and attention must mask to the window."""
    if cfg.sliding_window is not None and capacity <= cfg.sliding_window:
        return cfg.sliding_window
    if cfg.long_context_window is not None and capacity == cfg.long_context_window:
        return cfg.long_context_window
    return None


def _dense_layer_specs(cfg: ModelConfig) -> dict:
    specs = {
        "ln1": L.rmsnorm_spec(cfg.d_model),
        "ln2": L.rmsnorm_spec(cfg.d_model),
        "attn": attention_specs(cfg),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_specs(cfg)
    else:
        specs["mlp"] = L.mlp_specs(cfg)
    return specs


def _ffn(cfg: ModelConfig, lp: dict, h: torch.Tensor,
         tp: Optional[ModelParallel] = None) -> tuple[torch.Tensor, dict]:
    """The layer's second sublayer: the MoE block (with its aux) or the MLP."""
    if cfg.family == "moe":
        return moe_block(lp["moe"], h, cfg, tp)
    return L.mlp(lp["mlp"], h, split_by(tp, lp["mlp"]["up"].shape[-1], cfg.d_ff)), {}


def _sinusoid(s: int, d: int, device: torch.device) -> torch.Tensor:
    """The audio encoder's f32 position table (S, d): sin then cos."""
    half = d // 2
    freqs = 1.0 / (1e4 ** (torch.arange(half, dtype=torch.float32, device=device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mamba_layer_specs(cfg: ModelConfig) -> dict:
    return {"ln": L.rmsnorm_spec(cfg.d_model), "mixer": mamba2_specs(cfg)}


def _unstack(tree: Any) -> list:
    """The layers of a layer-stacked param tree (its leaves' first axis),
    as views.  One ``unbind`` per leaf: its gradient is one ``stack``,
    where indexing each layer would add a zero-filled stacked gradient per
    layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, checkpointed (recomputed in the backward) when
    ``cfg.remat`` and grad is on."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    tp: Optional[ModelParallel] = None
    feed: Any = None

    # ---------------- units (the feed's, or views of params) ----------------
    def _unit(self, params: dict, name: str) -> dict:
        """The leaves of a table unit (``embed``, ``projector``, ``shared``,
        ``head``) under their top-level keys: ``params`` itself without a
        feed."""
        return params if self.feed is None else self.feed.leaves(name)

    def _run(self, params: dict, name: str, fn, *args):
        """``fn(the table unit's leaves, *args)``."""
        if self.feed is None:
            return fn(params, *args)
        return self.feed.run(name, fn, *args)

    def _stack(self, params: dict) -> Optional[list]:
        """The layers (sites) as views of the stacked leaves, or None where
        the feed gathers them (``_layer``)."""
        return _unstack(params["layers"]) if self.feed is None else None

    def _layer(self, layers: Optional[list], i: int, fn, *args, remat: bool = True):
        """``fn(layer i's leaves, *args)``, under ``cfg.remat`` where grad
        is on (not for the decode step)."""
        if self.feed is None:
            return _remat(self.cfg, fn, layers[i], *args) if remat else fn(layers[i], *args)
        return self.feed.run(i, fn, *args, remat=remat and self.cfg.remat)

    # ---------------- specs ----------------
    def specs(self) -> dict:
        cfg = self.cfg
        specs: dict[str, Any] = {
            "final_ln": L.rmsnorm_spec(cfg.d_model),
            "lm_head": {"table": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                           ("vocab", "embed"), scale=1.0)},
        }
        if cfg.family == "audio":
            # positions are sinusoidal; HuBERT's conv positional encoding
            # is part of the stubbed frontend
            specs["frontend_proj"] = ParamSpec((cfg.frontend_dim, cfg.d_model), (None, "embed"))
        else:
            specs["embed"] = L.embed_specs(cfg)
        if cfg.family == "vlm":
            specs["projector"] = {
                "w1": ParamSpec((cfg.frontend_dim, cfg.d_model), (None, "embed")),
                "w2": ParamSpec((cfg.d_model, cfg.d_model), ("embed", "embed")),
            }
        if cfg.family in TRANSFORMER_FAMILIES:
            specs["layers"] = stack_specs(_dense_layer_specs(cfg), cfg.num_layers)
        elif cfg.family == "ssm":
            specs["layers"] = stack_specs(rwkv6_specs(cfg), cfg.num_layers)
        else:  # hybrid
            group = stack_specs(_mamba_layer_specs(cfg), cfg.attn_every)
            specs["layers"] = stack_specs(group, self.n_attn_sites())
            # Zamba2's shared block is a full transformer block (attn + MLP)
            specs["shared_attn"] = {
                "ln": L.rmsnorm_spec(cfg.d_model),
                "attn": attention_specs(cfg),
                "ln2": L.rmsnorm_spec(cfg.d_model),
                "mlp": L.mlp_specs(cfg),
            }
        return specs

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> dict:
        """Random weights from a ``torch.Generator`` on ``device`` seeded
        with ``seed``, with the reference's distributions."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(self.specs(), gen, resolve_dtype(self.cfg.param_dtype), device)

    def init_blocks(self, seed: int, device: str | torch.device, param_spec: dict,
                    mesh) -> dict:
        """This rank's blocks (``param_spec`` on ``mesh``) of ``init(seed,
        device)``, drawn leaf by leaf (a stacked leaf one layer at a time)
        and cut at once: the whole model is never held."""
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        def block(path: tuple, spec: ParamSpec):
            sp = param_spec
            for k in path:
                sp = sp[k]
            layout.check_spec(sp, spec.shape, mesh, "/".join(path))
            return layout.block_slices(spec.shape, sp, mesh)

        return init_params(self.specs(), gen, resolve_dtype(self.cfg.param_dtype), device,
                           block=block)

    def axes(self) -> dict:
        """Each leaf's logical axes, a tree like the params (the sharding
        rules map them onto a mesh: ``distributed.shard_params_spec``)."""
        return axes_tree(self.specs())

    def num_params(self, params: Optional[dict] = None) -> int:
        if params is not None:
            return count_params(params)
        return count_params_from_specs(self.specs())

    # ---------------- embedding / head ----------------
    def _embed_inputs(self, params: dict, batch: dict) -> torch.Tensor:
        """Hidden states (B, S, d) in the activation dtype: token
        embeddings; for vlm the projected patch embeddings then the text;
        for audio the projected frames plus the sinusoidal table."""
        cfg = self.cfg
        dtype = resolve_dtype(cfg.dtype)
        if cfg.family == "audio":
            x = self._run(params, "embed", lambda p, f: f.to(dtype) @ p["frontend_proj"],
                          batch["frames"])
            return x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(dtype)
        txt = self._run(params, "embed", self._embed, batch["tokens"]).to(dtype)
        if cfg.family != "vlm":
            return txt

        def project(p: dict, patches: torch.Tensor) -> torch.Tensor:
            img = patches.to(dtype) @ p["projector"]["w1"]
            img = F.gelu(img.float(), approximate="tanh").to(dtype)   # jax.nn.gelu's default
            return img @ p["projector"]["w2"]

        return torch.cat([self._run(params, "projector", project, batch["patch_embeds"]), txt],
                         dim=1)

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        table = params["embed"]["table"]
        return L.embed(params["embed"], tokens,
                       split_by(self.tp, table.shape[0], self.cfg.padded_vocab))

    def _vocab(self, params: dict) -> tuple[Optional[ModelParallel], int, int]:
        """(``tp`` where the head holds the rank's vocab rows, else None;
        the rank's first vocab column; how many of its columns are real
        vocab, not padding)."""
        n = params["lm_head"]["table"].shape[0]
        tp = split_by(self.tp, n, self.cfg.padded_vocab)
        v0 = 0 if tp is None else tp.index * n
        return tp, v0, max(0, min(n, self.cfg.vocab_size - v0))

    def _head(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Vocab logits (f32, exactly vocab_size columns; gathered over
        ``model`` where the head is split)."""
        return self._logits(self._unit(params, "head"), x)

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``_head`` on the head's leaves (``final_ln``, ``lm_head``)."""
        cfg = self.cfg
        tp, _, _ = self._vocab(params)
        x = L.rmsnorm(params["final_ln"], x, cfg.norm_eps)
        logits = gather_last(L.unembed(params["lm_head"], enter(x, tp)), tp)
        return logits[..., : cfg.vocab_size]

    def _shared_mlp(self, shared: dict, z: torch.Tensor) -> torch.Tensor:
        """Zamba2's shared MLP, column / row parallel where its leaves are
        the rank's blocks."""
        return L.mlp(shared["mlp"], z, split_by(self.tp, shared["mlp"]["up"].shape[-1],
                                                self.cfg.d_ff))

    # ---------------- forward (prefill) ----------------
    def _hidden(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Final pre-head hidden states (B, S, d) and the aux dict (for
        moe, each aux value's mean over the layers)."""
        cfg = self.cfg
        x = self._embed_inputs(params, batch)
        s = x.shape[1]
        positions = torch.arange(s, dtype=torch.int32, device=x.device)
        causal = not cfg.encoder_only
        window = cfg.effective_window(s)
        layers = self._stack(params)
        if cfg.family == "ssm":
            for i in range(cfg.num_layers):
                x = self._layer(layers, i, rwkv6_block, x, cfg, self.tp)
            return x, {}
        if cfg.family == "hybrid":
            shared = self._unit(params, "shared")["shared_attn"]

            def site(site_params: dict, x: torch.Tensor) -> torch.Tensor:
                for lp in _unstack(site_params):
                    z = L.rmsnorm(lp["ln"], x, cfg.norm_eps)
                    x = x + mamba2_block(lp["mixer"], z, cfg, self.tp)
                z = L.rmsnorm(shared["ln"], x, cfg.norm_eps)
                x = x + attention_block(shared["attn"], z, cfg, positions, causal, window,
                                        self.tp)
                z = L.rmsnorm(shared["ln2"], x, cfg.norm_eps)
                return x + self._shared_mlp(shared, z)

            for i in range(self.n_attn_sites()):
                x = self._layer(layers, i, site, x)
            return x, {}

        def layer(lp: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
            h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
            x = x + attention_block(lp["attn"], h, cfg, positions, causal, window, self.tp)
            h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
            y, aux = _ffn(cfg, lp, h, self.tp)
            return x + y, aux

        auxs = []
        for i in range(cfg.num_layers):
            x, aux = self._layer(layers, i, layer, x)
            auxs.append(aux)
        return x, {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Full logits (B, S, vocab_size) and the aux dict (empty but for
        moe: load_balance_loss, router_z_loss, drop_fraction)."""
        x, aux = self._hidden(params, batch)
        return self._head(params, x), aux

    def prefill(self, params: dict, batch: dict) -> torch.Tensor:
        """Next-token logits for the final position only (B, vocab)."""
        x, _ = self._hidden(params, batch)
        return self._head(params, x[:, -1:, :])[:, 0]

    # ---------------- loss ----------------
    def _chunk_nll(self, params: dict, h: torch.Tensor, t: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
        """Masked NLL summed over one chunk: f32 logits, their logsumexp and
        the picked logit.  The port's ``_head`` returns exactly vocab_size
        columns, where the reference's chunked CE keeps the padded width
        with the padding at -1e9 (``sliced=False``): exp(-1e9 - max) is 0
        in f32, so those columns add nothing to the logsumexp and the
        value is the same.

        Where the head is split over ``model`` the cross-entropy is
        vocab-parallel: each rank's columns cut to real vocab (the padding
        lies on the last ranks and drops out as the slice drops it), a
        detached all-reduce MAX of the rows' maxima, the sum of the exps
        and the target's logit (picked on the rank that holds it) summed
        over ``model``."""
        tp, v0, nv = self._vocab(params)
        if tp is None:
            logits = self._logits(params, h)
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(-1, t.long()[..., None])[..., 0]
            return ((lse - picked) * m).sum()
        x = L.rmsnorm(params["final_ln"], h, self.cfg.norm_eps)
        logits = L.unembed(params["lm_head"], enter(x, tp))[..., :nv]
        lead = logits.shape[:-1]
        mx = (logits.detach().amax(-1) if nv else
              torch.full(lead, -torch.inf, dtype=logits.dtype, device=logits.device))
        mx = tp.all_reduce(mx, "max")
        lse = mx + torch.log(leave(torch.exp(logits - mx[..., None]).sum(-1), tp))
        local = t.long() - v0
        inside = (local >= 0) & (local < nv)
        picked = (logits.gather(-1, local.clamp(0, max(nv - 1, 0))[..., None])[..., 0] if nv
                  else torch.zeros(lead, dtype=logits.dtype, device=logits.device))
        picked = leave(torch.where(inside, picked, 0.0), tp)
        return ((lse - picked) * m).sum()

    def _chunked_ce(self, params: dict, hidden: torch.Tensor, targets: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-entropy over (B, S) targets from (B, S, d) hidden states in
        sequence chunks of ``cfg.loss_chunk`` (shrunk to a divisor of S, as
        the reference), each checkpointed under grad, so the full
        (B, S, V) f32 logits are never live; the masked mean is
        ``tot / max(cnt, 1)``."""
        cfg = self.cfg
        s = hidden.shape[1]
        chunk = cfg.loss_chunk if cfg.loss_chunk and s > cfg.loss_chunk else s
        while s % chunk:
            chunk -= 1
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32, device=targets.device)
        # the head, gathered once and taken by every chunk as an input
        params = self._unit(params, "head")
        tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, s, chunk):
            args = (params, hidden[:, i:i + chunk], targets[:, i:i + chunk], mask[:, i:i + chunk])
            if torch.is_grad_enabled():
                nll = checkpoint(self._chunk_nll, *args, use_reentrant=False)
            else:
                nll = self._chunk_nll(*args)
            tot = tot + nll
            cnt = cnt + args[3].sum()
        return tot / torch.clamp(cnt, min=1.0)

    def ce_targets(self, batch: dict) -> torch.Tensor:
        """The count ``loss``'s cross-entropy divides by (f32, before the
        clamp to 1): the masked frames (``labels >= 0``) for the encoder,
        else each row's next-token targets (text only for vlm)."""
        if self.cfg.encoder_only:
            return (batch["labels"] >= 0).sum().float()
        t = batch["tokens"]
        return torch.tensor(float(t.shape[0] * (t.shape[1] - 1)), device=t.device)

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """The training loss and its metrics: next-token CE (for vlm over
        the text positions only; for the encoder over the masked frames,
        ``labels >= 0``), plus for moe ``0.01·load_balance_loss +
        1e-3·router_z_loss`` with the aux in the metrics."""
        cfg = self.cfg
        hidden, aux = self._hidden(params, batch)
        if cfg.encoder_only:
            labels = batch["labels"]                  # (B, S), -1 = unmasked
            mask = (labels >= 0).float()
            ce = self._chunked_ce(params, hidden, labels.clamp_min(0), mask)
        else:
            tokens = batch["tokens"]
            if cfg.family == "vlm":
                # predict text tokens only; hidden covers [img; txt]
                hidden = hidden[:, batch["patch_embeds"].shape[1]:]
            ce = self._chunked_ce(params, hidden[:, :-1], tokens[:, 1:])
        total = ce
        metrics = {"ce": ce}
        if "load_balance_loss" in aux:
            total = total + 0.01 * aux["load_balance_loss"] + 1e-3 * aux["router_z_loss"]
            metrics.update(aux)
        metrics["loss"] = total
        return total, metrics

    # ---------------- decode ----------------
    def n_attn_sites(self) -> int:
        cfg = self.cfg
        if cfg.family == "hybrid":
            return cfg.num_layers // cfg.attn_every
        if cfg.family == "ssm":
            return 0
        return cfg.num_layers

    def init_decode_state(self, batch: int, context: int, device: str | torch.device = "cuda",
                          mesh=None, rules=None) -> DecodeState:
        """The empty decode state; with ``mesh`` and ``rules`` this rank's
        blocks of it, laid out by ``decode_state_spec``."""
        if mesh is not None:
            whole = self.init_decode_state(batch, context, "meta")
            specs = decode_state_spec(self.cfg, mesh, rules, whole)

            def block(t, spec):
                if t is None:
                    return None
                if isinstance(t, tuple):
                    return type(t)(*(block(a, b) for a, b in zip(t, spec)))
                spec = tuple(spec)
                layout.check_spec(spec, tuple(t.shape), mesh, "decode state")
                fill = -1 if (t.dtype == torch.int32 and t.dim() == 1) else 0
                return torch.full(layout.block_shape(tuple(t.shape), spec, mesh), fill,
                                  dtype=t.dtype, device=device)

            return block(whole, specs)
        cfg = self.cfg
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        dtype = resolve_dtype(cfg.dtype)
        if cfg.family == "ssm":
            return DecodeState(rwkv=init_rwkv_state(cfg, batch, dtype, cfg.num_layers, device))
        kv = init_kv_cache(cfg, batch, context, dtype, self.n_attn_sites(), device=device)
        if cfg.family == "hybrid":
            return DecodeState(kv=kv, ssm=init_ssm_state(cfg, batch, dtype, cfg.num_layers,
                                                         device))
        return DecodeState(kv=kv)

    def decode_step(self, params: dict, state: DecodeState,
                    tokens: torch.Tensor) -> tuple[torch.Tensor, DecodeState]:
        """tokens: (B,) one new token per sequence.  Updates ``state``'s
        caches and recurrent states in place and returns it with the
        logits (B, vocab)."""
        cfg = self.cfg
        x = self._run(params, "embed", self._embed, tokens[:, None]).to(resolve_dtype(cfg.dtype))
        layers = self._stack(params)
        if cfg.family == "ssm":
            st = state.rwkv
            for i in range(cfg.num_layers):
                x = self._layer(layers, i, lambda lp, x, i: rwkv6_decode_step(
                    lp, x, cfg, st.s[i], st.shift_t[i], st.shift_c[i], self.tp), x, i, remat=False)
            return self._head(params, x)[:, 0], state

        cache = state.kv
        window = _decode_window(cfg, cache.positions.shape[0])
        slot = cache_write_slot(cache.positions, cache.next_pos)
        cache.positions.index_copy_(0, slot, cache.next_pos.reshape(1))
        if cfg.family == "hybrid":
            ssm, shared = state.ssm, self._unit(params, "shared")["shared_attn"]

            def site_step(site_params: dict, x: torch.Tensor, site: int) -> torch.Tensor:
                for j, lp in enumerate(_unstack(site_params)):
                    i = site * cfg.attn_every + j
                    z = L.rmsnorm(lp["ln"], x, cfg.norm_eps)
                    x = x + mamba2_decode_step(lp["mixer"], z, cfg, ssm.h[i], ssm.conv[i],
                                               self.tp)
                z = L.rmsnorm(shared["ln"], x, cfg.norm_eps)
                x = x + decode_attention_block(
                    shared["attn"], z, cfg, cache.k[site], cache.v[site], cache.positions,
                    cache.next_pos, slot, window, self.tp)
                z = L.rmsnorm(shared["ln2"], x, cfg.norm_eps)
                return x + self._shared_mlp(shared, z)

            for site in range(self.n_attn_sites()):
                x = self._layer(layers, site, site_step, x, site, remat=False)
        else:
            def layer_step(lp: dict, x: torch.Tensor, i: int) -> torch.Tensor:
                h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
                x = x + decode_attention_block(
                    lp["attn"], h, cfg, cache.k[i], cache.v[i], cache.positions,
                    cache.next_pos, slot, window, self.tp)
                h = L.rmsnorm(lp["ln2"], x, cfg.norm_eps)
                return x + _ffn(cfg, lp, h, self.tp)[0]

            for i in range(cfg.num_layers):
                x = self._layer(layers, i, layer_step, x, i, remat=False)
        cache.next_pos.add_(1)
        return self._head(params, x)[:, 0], state
