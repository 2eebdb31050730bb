"""Composable decoder LM, mirroring ``repro/models/transformer.py``:
training (``loss_fn``) and serving (prefill and batched decode).

A config is compiled to a *block pattern* (list of slots, each slot =
mixer + optional FFN); the ``n_layers / len(pattern)`` groups keep
layer-stacked parameters with a leading ``[G, ...]`` dim, as in the
reference, and ``_backbone`` loops over the groups in Python where the
reference runs ``lax.scan``.

Families, every one of which trains and serves:
  dense/audio : attn + mlp                      (audio: codebook embeds/heads)
  moe         : attn + moe
  hybrid      : mamba/attn interleave + mlp/moe (Jamba)
  vlm         : attn + cross-attn every Nth     (Llama-3.2-Vision)
  ssm         : mlstm/slstm blocks              (xLSTM)

The VLM's batches carry ``patches`` [B, n_patches, D], the projected image
patch embeddings its cross-attention slots attend to; the audio family's
tokens and targets are [B, S, n_cb], one stream per codebook, embedded as
the sum of the codebooks' embeddings and predicted by one head each.

``loss_fn`` takes the nested params or their flat view
(``repro_torch.pytree.flat_dict``: ``/``-joined leaf paths in ``jax.tree``
order, the layout the round, the update pipeline and the checkpoints use)
and writes nothing in place, so the parallel round can run it under
``vmap(grad_and_value)`` over the clients' stacked params.

Under a ``model`` mesh axis larger than 1 (``models.sharding``) the params
are the rank's shares as their specs cut them, and each layer splits over
the axis where it divides: the MLPs column- then row-parallel, the
embedding over D and the unembedding over the padded vocab (its logits
gathered whole), attention over its query heads where ``attn_tp`` holds
(``wk``/``wv`` whole, each rank's heads meeting their own KV heads), and
the mixers as their modules say.  Serving there holds the decode state as
``state_logical_specs`` cuts it (``init_decode_state``): each attention
cache holds the rank's contiguous share of its slots where the axis
divides them, prefill writes the rank's slots (a sliding window's ring
reckoned whole, then cut), decode writes the new token's K and V on the
rank that owns its slot, attends every query head over the rank's slots
(the rank's heads gathered first where ``attn_tp`` splits them) and joins
the shards' partial softmaxes (``sharding.merge_partials``).

FSDP over ``data``: where ``data`` is larger than 1 the params are held
cut over it too, as their specs say (``unembed``, ``wq``/``wk``/``wv``/
``wo``, the MLP's ``w1``/``w3``/``w2``, Mamba's ``in_proj``/``out_proj``,
the xLSTM's ``up``/``down`` and gate projections on their ``d_model``
dims; the experts on their F dim).  Each slot's leaves (one layer) are
gathered over ``data`` just before the slot runs and held by nothing
after it (``_gathered``), in training, prefill and decode; in training
the remat unit is then the slot, so its saved inputs are the shares and
its recompute gathers again (``_backbone``).  The MoE gathers its experts
itself (``moe.moe_apply``), and ``unembed`` is gathered once before the
logits.  A client body whose client dim owns ``data`` (``exclude_axes``)
takes the params whole over it and gathers nothing.

Decode states are written in place: ``prefill`` fills the state that
``init_decode_state`` made, and ``decode_step`` updates the state it is
given and returns it (JAX's arrays are immutable; a caller that needs the
old state clones it).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import memory
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import sharding as sh
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import (DTYPES, ParamBuilder, apply_rope,
                                       cross_entropy_logits, glu_mlp,
                                       plain_mlp, rms_norm, take_embedding)
from repro_torch.pytree import flat_dict, nest

@dataclass(frozen=True)
class Slot:
    mixer: str          # attn | cross | mamba | mlstm | slstm
    ffn: str            # mlp | moe | none


def block_pattern(cfg: ModelConfig) -> list[Slot]:
    if cfg.xlstm is not None:
        p = cfg.xlstm.slstm_every
        return [Slot("slstm" if i % p == p - 1 else "mlstm", "none")
                for i in range(p)]
    period = 1
    if cfg.attn_every:
        period = cfg.attn_every
    if cfg.cross_attn_every:
        period = math.lcm(period, cfg.cross_attn_every)
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every)
    slots = []
    for i in range(period):
        if cfg.attn_every:
            mixer = "attn" if i % cfg.attn_every == cfg.attn_every - 1 else "mamba"
        elif cfg.cross_attn_every:
            mixer = "cross" if i % cfg.cross_attn_every == cfg.cross_attn_every - 1 else "attn"
        else:
            mixer = "attn"
        ffn = "mlp"
        if cfg.moe is not None and i % cfg.moe.every == cfg.moe.every - 1:
            ffn = "moe"
        slots.append(Slot(mixer, ffn))
    return slots


class _GroupRemat(torch.autograd.Function):
    """A layer group rematerialised, for ``torch.func`` transforms (which
    take neither form of ``torch.utils.checkpoint``).  ``run(x, aux,
    positions, patches, leaves) -> (x, aux)`` is the group; the forward
    saves only its inputs (``leaves`` are the group's parameter leaves),
    and the backward runs the group again under ``torch.func.vjp``, so the
    group's activations live only while its backward runs.  The vmap rule
    is generated: under the round's ``vmap`` the recompute and its vjp
    are vmapped too."""
    generate_vmap_rule = True

    @staticmethod
    def forward(run, x, aux, positions, patches, *leaves):
        return run(x, aux, positions, patches, leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, x, aux, positions, patches, *leaves = inputs
        ctx.run = run
        ctx.save_for_backward(x, aux, positions, patches, *leaves)

    @staticmethod
    def backward(ctx, g_x, g_aux):
        x, aux, positions, patches, *leaves = ctx.saved_tensors
        _, vjp_fn = torch.func.vjp(
            lambda x, aux, *lv: ctx.run(x, aux, positions, patches, lv),
            x, aux, *leaves)
        # torch.func.grad runs backward with create_graph: a cotangent
        # that kept its graph would keep the recompute's activations alive
        # to the end of the whole backward.  Nothing takes a second
        # derivative through a group (the scan's backward kernel has none),
        # so the cotangents leave without it.
        g_in = tuple(g.detach() for g in vjp_fn((g_x, g_aux)))
        return (None, g_in[0], g_in[1], None, None) + g_in[2:]


class DecodeState(dict):
    """The decode state, ``{slot: {leaf: tensor}}``, with ``cache_len``,
    the whole length of its attention caches: a cache split over ``model``
    holds a share of its slots, and decode reckons slots on the whole
    ring."""

    def __init__(self, slots: dict, cache_len: int):
        super().__init__(slots)
        self.cache_len = cache_len


def _tree_index(tree, g):
    return {k: _tree_index(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.pattern = block_pattern(cfg)
        if cfg.n_layers % len(self.pattern):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not fill "
                             f"whole groups of {len(self.pattern)}")
        self.n_groups = cfg.n_layers // len(self.pattern)
        # shard attention heads over `model` only when divisible by the
        # largest production model axis (16); else attention is replicated
        # across `model` (the MLP stays tensor parallel)
        self.attn_tp = cfg.n_heads % 16 == 0
        self.dtype = DTYPES[cfg.dtype]
        self._cuts = {}                 # mesh shape -> (leaf_cuts, data_cuts)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, device="cpu",
             keep=None) -> dict:
        """Random params with the reference's shapes, scales and init rules,
        drawn from ``generator`` (on its own device) in the reference's
        order and cast to the config's dtype on ``device``; ``keep``, where
        given, cuts each leaf as it is drawn (``ParamBuilder``)."""
        return self._build(ParamBuilder(generator, self.dtype, device, keep))

    def param_specs(self) -> dict:
        """The params' tree with every leaf an empty tensor of its shape
        and dtype on the ``meta`` device: nothing is allocated (the
        reference's ShapeDtypeStruct tree).  Shapes only: no memory count
        (``launch.memory``) charges them to a step that asks for them."""
        with memory.uncharged():
            return self._build(ParamBuilder(None, self.dtype, "meta"))

    @property
    def logical_specs(self) -> dict:
        """The tree of logical-axis tuples, the params' structure (built
        on the ``meta`` device: nothing is allocated)."""
        pb = ParamBuilder(None, self.dtype, "meta")
        with memory.uncharged():
            self._build(pb)
        return pb.specs

    def _build(self, pb: ParamBuilder) -> dict:
        cfg = self.cfg
        D, V, Vp = cfg.d_model, cfg.vocab, cfg.vocab_padded
        H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
        G = self.n_groups
        emb_scale = 1.0 / math.sqrt(D)
        if cfg.n_codebooks:
            pb.add(["embed"], (cfg.n_codebooks, V, D), (None, None, sh.MODEL),
                   scale=emb_scale)
            pb.add(["unembed"], (D, cfg.n_codebooks * Vp),
                   (sh.DATA, sh.MODEL))
        else:
            pb.add(["embed"], (V, D), (None, sh.MODEL), scale=emb_scale)
            pb.add(["unembed"], (D, Vp), (sh.DATA, sh.MODEL))
        pb.add(["final_norm"], (D,), (None,), init="ones")
        model_ax = sh.MODEL if self.attn_tp else None
        for si, slot in enumerate(self.pattern):
            base = ["layers", f"slot{si}"]
            pb.add(base + ["norm1"], (G, D), (None, None), init="ones")
            if slot.mixer in ("attn", "cross"):
                pb.add(base + ["wq"], (G, D, H * hd), (None, sh.DATA, model_ax))
                pb.add(base + ["wk"], (G, D, KV * hd), (None, sh.DATA, None))
                pb.add(base + ["wv"], (G, D, KV * hd), (None, sh.DATA, None))
                pb.add(base + ["wo"], (G, H * hd, D), (None, model_ax, sh.DATA))
            elif slot.mixer == "mamba":
                mamba_mod.init_mamba(pb, base + ["mamba"], D, cfg.mamba, G)
            elif slot.mixer == "mlstm":
                xlstm_mod.init_mlstm(pb, base + ["mlstm"], D, H, cfg.xlstm, G)
            elif slot.mixer == "slstm":
                xlstm_mod.init_slstm(pb, base + ["slstm"], D, H, G)
            if slot.ffn != "none":
                pb.add(base + ["norm2"], (G, D), (None, None), init="ones")
            if slot.ffn == "mlp":
                F = cfg.d_ff
                pb.add(base + ["w1"], (G, D, F), (None, sh.DATA, sh.MODEL))
                if cfg.act in ("swiglu", "geglu"):
                    pb.add(base + ["w3"], (G, D, F), (None, sh.DATA, sh.MODEL))
                pb.add(base + ["w2"], (G, F, D), (None, sh.MODEL, sh.DATA))
            elif slot.ffn == "moe":
                moe_mod.init_moe(pb, base + ["moe"], D, cfg.moe, G)
        return pb.params

    # -------------------------------------------------------------- embedding
    def embed(self, params, tokens):
        """The embeddings of ``tokens``; a table split over ``model`` (its
        D) is looked up in the rank's share and the shares gathered."""
        tp = sh.model_split(self.cfg.d_model) > 1
        if self.cfg.n_codebooks:
            # tokens [B, S, n_cb] -> the codebooks' embeddings summed in
            # codebook order, as the reference's sum(), gathered once
            x = sum(take_embedding(params["embed"][c], tokens[..., c])
                    for c in range(self.cfg.n_codebooks))
            x = sh.gather_from_model(x, -1) if tp else x
        else:
            x = take_embedding(params["embed"], tokens, tp=tp)
        return sh.shard(x, sh.BATCH, None, None)

    def _unembed(self, params) -> dict:
        """``params`` with ``unembed`` gathered over ``data`` where it is
        cut there (its D, ``(DATA, MODEL)``)."""
        return dict(params, **self._gathered(
            {"unembed": params["unembed"]}, ""))

    def logits(self, params, x):
        """``x @ unembed``.  An unembedding split over ``model`` (its padded
        vocab) is column-parallel: the rank's logits, gathered whole for
        the cross-entropy that every rank repeats."""
        cfg = self.cfg
        if sh.model_split(max(cfg.n_codebooks, 1) * cfg.vocab_padded) > 1:
            lg = sh.gather_from_model(sh.copy_to_model(x)
                                      @ params["unembed"], -1)
        else:
            lg = x @ params["unembed"]
        if self.cfg.n_codebooks:
            lg = lg.reshape(*lg.shape[:-1], self.cfg.n_codebooks,
                            self.cfg.vocab_padded)
        return lg

    # ------------------------------------------------------------------ slots
    def _heads_split(self) -> int:
        """The shards of the query heads over ``model`` (1: attention runs
        whole on every rank): with ``attn_tp``, where the axis divides
        the heads, as the reference shards ``wq``/``wo``."""
        cfg = self.cfg
        if not self.attn_tp:
            return 1
        m = sh.model_split(cfg.n_heads * cfg.hd)
        if m > 1 and cfg.n_heads % m:
            raise ValueError(f"{cfg.name}: {cfg.n_heads} heads do not split "
                             f"over a `model` axis of {m}")
        return m

    def _kv_share(self, k, m):
        """K or V [B, T, KV, hd], whole on every rank, repeated to the
        query heads and cut to the rank's ``H / m`` (each query head meets
        its own KV head, ``h // (H / KV)``); the cut's backward gathers the
        ranks' cotangents, so ``wk``/``wv`` take the whole gradient."""
        ke = k.repeat_interleave(self.cfg.n_heads // self.cfg.kv_heads,
                                 dim=2)
        return sh.scatter_to_model(ke, 2) if m > 1 else ke

    def _cross(self, p, x, *, mode, cache, patches):
        """Cross attention to the image patches: K and V are projections of
        ``patches`` (cast to the model dtype), computed in train and
        prefill mode, where prefill writes them into ``cache`` in place,
        and read from ``cache`` in decode mode (``patches`` unused)."""
        cfg = self.cfg
        B, S, D = x.shape
        H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
        m = self._heads_split()
        xq = sh.copy_to_model(x) if m > 1 else x
        q = (xq @ p["wq"]).reshape(B, S, H // m, hd)
        if mode == "decode":
            k, v = cache["k"], cache["v"]
        else:
            if patches is None:
                raise ValueError(f"{cfg.name}: a cross-attention slot needs "
                                 f"the batch's patches")
            kv_src = patches.to(x.dtype)
            k = (kv_src @ p["wk"]).reshape(B, -1, KV, hd)
            v = (kv_src @ p["wv"]).reshape(B, -1, KV, hd)
            if mode == "prefill":
                cache["k"].copy_(k)
                cache["v"].copy_(v)
        if m > 1:
            k, v = self._kv_share(k, m), self._kv_share(v, m)
        out = attn.cross_attend(q, k, v)
        out = out.reshape(B, S, H // m * hd) @ p["wo"]
        return sh.reduce_from_model(out) if m > 1 else out

    def _attn(self, p, x, *, positions, window, mode, cache, pos=None,
              cache_len=None):
        cfg = self.cfg
        B, S, D = x.shape
        H, KV, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
        # with the heads split over `model`: wq column-parallel over the
        # rank's heads, wk/wv whole, wo row-parallel
        m = self._heads_split()
        xq = sh.copy_to_model(x) if m > 1 else x
        q = (xq @ p["wq"]).reshape(B, S, H // m, hd)
        k = (x @ p["wk"]).reshape(B, S, KV, hd)
        v = (x @ p["wv"]).reshape(B, S, KV, hd)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

        if mode == "decode":
            out = self._decode_attend(q[:, 0], k, v, cache, pos, window,
                                      cache_len, m)[:, None]  # [B,1,H/m,hd]
        else:
            m_ax = sh.MODEL if self.attn_tp else None
            q = sh.shard(q, sh.BATCH, None, m_ax, None)
            ke = sh.shard(self._kv_share(k, m), sh.BATCH, None, m_ax, None)
            ve = sh.shard(self._kv_share(v, m), sh.BATCH, None, m_ax, None)
            out = attn.attend(q, ke, ve, causal=True, window=window)
            del ke, ve
        if mode == "prefill":
            self._fill_cache(cache, k, v, window, cache_len)
        out = out.reshape(B, S, H // m * hd) @ p["wo"]
        return sh.reduce_from_model(out) if m > 1 else out

    @staticmethod
    def _fill_cache(cache, k, v, window, cache_len):
        """Prefill's write of the prompt's K and V [B, S, KV, hd] into the
        rank's slots ``model_slice(cache_len)`` of the caches: positions in
        order, or with a sliding window the last ``cache_len`` of them on
        the ring, placed so that slot = pos % cache_len (the ring reckoned
        whole, then cut)."""
        S = k.shape[1]
        off, n = sh.model_slice(cache_len)
        for c, src in ((cache["k"], k), (cache["v"], v)):
            if window:
                start = S - cache_len if S >= cache_len else 0
                ring = torch.zeros((c.shape[0], cache_len) + c.shape[2:],
                                   dtype=c.dtype, device=c.device)
                ring[:, :S - start] = src[:, start:].to(c.dtype)
                c.copy_(torch.roll(ring, start % cache_len,
                                   dims=1)[:, off:off + n])
            elif S > off:
                attn.cache_write(c, src[:, off:off + n], 0)

    def _decode_attend(self, q1, k, v, cache, pos, window, cache_len, m):
        """One decode step's attention: the new token's K and V [B,1,KV,hd]
        written at slot ``pos`` (``pos % cache_len`` on a ring) by the rank
        that owns that slot, then q1 [B, H/m, hd] (the rank's query heads)
        against the cache.  With the heads split (``m`` > 1) the heads are
        gathered and every rank attends all of them over its slots, then
        keeps its own for the row-parallel ``wo``.  A cache split over
        ``model`` gives each rank its shard's partial softmax, joined by
        ``sharding.merge_partials`` and cast to the model dtype once."""
        B, H, hd = q1.shape[0], self.cfg.n_heads, self.cfg.hd
        off, n = sh.model_slice(cache_len)
        slot = pos % cache_len if window else pos
        if not 0 <= slot < cache_len:
            raise IndexError(f"decode at position {pos} past a cache of "
                             f"{cache_len}")
        if off <= slot < off + n:
            attn.cache_write(cache["k"], k, slot - off)
            attn.cache_write(cache["v"], v, slot - off)
        if m > 1:
            q1 = sh.gather_to_model(q1, 1)
        if n == cache_len:
            out = attn.decode_attend(q1, cache["k"], cache["v"], pos,
                                     window=window)
        else:
            out = sh.merge_partials(*attn.decode_partials(
                q1, cache["k"], cache["v"], pos, window=window, offset=off,
                total=cache_len)).reshape(B, H, hd).to(q1.dtype)
        return sh.scatter_to_model(out, 1) if m > 1 else out

    def _ffn(self, slot, p, x, mode):
        cfg = self.cfg
        if slot.ffn == "mlp":
            tp = sh.model_split(cfg.d_ff) > 1
            if cfg.act in ("swiglu", "geglu"):
                return glu_mlp(x, p["w1"], p["w3"], p["w2"], cfg.act,
                               tp=tp), 0.0
            return plain_mlp(x, p["w1"], p["w2"], cfg.act, tp=tp), 0.0
        moe_mode = "gather_tokens" if mode == "decode" else "gather_weights"
        return moe_mod.moe_apply(p["moe"], x, cfg=cfg.moe, act=cfg.act,
                                 mode=moe_mode)

    def _apply_slot(self, slot: Slot, p, x, *, mode, positions=None,
                    cache=None, pos=None, patches=None, cache_len=None):
        """One slot.  ``cache`` is this slot's decode state for this group,
        updated in place; in ``mode="train"`` there is none."""
        cfg = self.cfg
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        if slot.mixer == "attn":
            out = self._attn(p, h, positions=positions,
                             window=cfg.sliding_window, mode=mode,
                             cache=cache, pos=pos, cache_len=cache_len)
        elif slot.mixer == "cross":
            out = self._cross(p, h, mode=mode, cache=cache, patches=patches)
        else:
            if slot.mixer == "mamba":
                out, new_state = mamba_mod.mamba_apply(
                    p["mamba"], h, cfg=cfg.mamba, mode=mode, state=cache)
            elif slot.mixer == "mlstm":
                out, new_state = xlstm_mod.mlstm_apply(
                    p["mlstm"], h, n_heads=cfg.n_heads, cfg=cfg.xlstm,
                    mode=mode, state=cache)
            elif slot.mixer == "slstm":
                out, new_state = xlstm_mod.slstm_apply(
                    p["slstm"], h, n_heads=cfg.n_heads, mode=mode,
                    state=cache)
            else:
                raise ValueError(slot.mixer)
            for name, t in (new_state or {}).items():
                cache[name].copy_(t)
            del new_state
        x = x + out
        aux = 0.0
        if slot.ffn != "none":
            h = rms_norm(x, p["norm2"], cfg.norm_eps)
            out, aux = self._ffn(slot, p, h, mode)
            x = x + out
        return x, aux

    # ---------------------------------------------------------------- forward
    def _rest_cuts(self) -> tuple:
        """(``leaf_cuts()``, ``data_cuts()``) on the active mesh, worked
        out once for each mesh shape."""
        mesh = sh.get_mesh()
        if mesh is None:
            return {}, {}
        key = tuple(mesh.shape.items())
        if key not in self._cuts:
            from repro_torch.launch.specs import leaf_cuts
            shapes = {k: tuple(v.shape)
                      for k, v in flat_dict(self.param_specs()).items()}
            cuts = leaf_cuts(shapes, self.logical_specs, mesh)
            self._cuts[key] = cuts, {k: c[sh.DATA] - len(shapes[k])
                                     for k, c in cuts.items() if sh.DATA in c}
        return self._cuts[key]

    def leaf_cuts(self) -> dict:
        """``{leaf: {axis: dim}}`` (flat names) of the param leaves that
        their sanitised specs cut over the active mesh's ``data`` and
        ``model`` axes at rest (``launch.specs.leaf_cuts``); empty where
        there is no mesh."""
        return self._rest_cuts()[0]

    def data_cuts(self) -> dict:
        """``{leaf: dim}`` (negative dims, so they hold on one group's
        slice) of the leaves that ``leaf_cuts`` cuts over ``data``; empty
        where ``data`` is 1 or there is no mesh."""
        return self._rest_cuts()[1]

    def _gathered(self, tree, prefix: str):
        """``tree`` (a nested slice of the params at ``prefix``) with each
        leaf that ``data_cuts`` cuts gathered whole over ``data``
        (``sharding.gather_from_data``: FSDP's per-layer gather, whose
        backward is the reduce-scatter).  The MoE's experts are left cut:
        ``moe.moe_apply`` gathers them in train and prefill and keeps them
        cut in decode.  Where ``data`` is not active (no mesh, or a client
        dim that owns it) the tree as it is."""
        cuts = self.data_cuts() if sh.data_live() else {}
        if not cuts:
            return tree
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = v if k == "moe" else self._gathered(v, path)
            elif path in cuts:
                out[k] = sh.gather_from_data(v, cuts[path])
            else:
                out[k] = v
        return out

    def _group(self, gp, x, aux, *, mode, positions, gc=None, pos=None,
               patches=None, cache_len=None):
        """One layer group, or the slots of it that ``gp`` holds: its slots
        in order, each slot's aux added to ``aux``.  Each slot's weights
        are gathered over ``data`` just before the slot runs and held by
        nothing after it (``_gathered``).  Returns (x, aux)."""
        for si, slot in enumerate(self.pattern):
            key = f"slot{si}"
            if key not in gp:
                continue
            x, a = self._apply_slot(slot, self._gathered(gp[key],
                                                         f"layers/{key}"),
                                    x, mode=mode, positions=positions,
                                    cache=None if gc is None else gc.get(key),
                                    pos=pos, patches=patches,
                                    cache_len=cache_len)
            aux = aux + a
            x = sh.shard(x, sh.BATCH, None, None)
        return x, aux

    def _backbone(self, params, x, *, mode, positions, caches, pos=None,
                  patches=None, remat=True, cache_len=None):
        """Loop over layer groups, updating ``caches`` in place (``{}`` in
        ``mode="train"``, which writes nothing in place).  Returns (x, aux
        mean).  In ``mode="train"`` with ``remat`` each group runs
        rematerialised, as the reference's ``jax.checkpoint(group_fn)``:
        its forward keeps only the group's inputs, and the backward runs
        the group again (``_GroupRemat``).  Where ``data`` is active the
        unit is one slot (a layer): its inputs are the weights' ``data``
        shares, and the recompute gathers them again, so one layer's
        gathered weights are alive at a time in the recompute too."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        per_slot = sh.data_live() and bool(self.data_cuts())
        for g in range(self.n_groups):
            gp = _tree_index(params["layers"], g)
            if remat and mode == "train":
                units = ([[f"slot{i}"] for i in range(len(self.pattern))]
                         if per_slot else [list(gp)])
                for keys in units:
                    flat = flat_dict({k: gp[k] for k in keys})

                    def run(x, aux, positions, patches, leaves,
                            keys=tuple(flat)):
                        return self._group(nest(dict(zip(keys, leaves))), x,
                                           aux, mode="train",
                                           positions=positions,
                                           patches=patches)

                    x, aux = _GroupRemat.apply(run, x, aux, positions,
                                               patches, *flat.values())
            else:
                x, aux = self._group(gp, x, aux, mode=mode,
                                     positions=positions,
                                     gc=_tree_index(caches, g), pos=pos,
                                     patches=patches, cache_len=cache_len)
        return x, aux / self.cfg.n_layers

    # ------------------------------------------------------------------ train
    def loss_fn(self, params, batch):
        """batch: tokens [B, S] and targets [B, S] integers ([B, S, n_cb]
        with codebooks), and for the VLM patches [B, n_patches, D].
        Returns (loss, {"ce", "aux"}); the MoE load-balance term is in the
        loss and, as in the reference, in "ce" too."""
        cfg = self.cfg
        params = nest(params)      # the flat view's tensors, not copies
        tokens = batch["tokens"]
        x = self.embed(params, tokens)
        S = tokens.shape[1]
        positions = torch.arange(S, device=x.device)
        x, aux = self._backbone(params, x, mode="train", positions=positions,
                                caches={}, patches=batch.get("patches"))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        # chunked CE fused with the unembedding (bounds the f32 workspace);
        # the unembedding gathered over `data` once, for every chunk
        chunk = 512 if S * cfg.vocab_padded > (1 << 24) else 0
        loss = self._ce_from_hidden(self._unembed(params), x,
                                    batch["targets"], chunk)
        if cfg.moe is not None:
            loss = loss + cfg.moe.load_balance_coef * aux
        return loss, {"ce": loss, "aux": aux}

    def _ce_from_hidden(self, params, x, targets, chunk):
        """Mean CE of the hidden states' logits; with ``chunk``, the logits
        of ``chunk`` positions at a time, averaged as the reference does."""
        cfg = self.cfg
        if not chunk or x.shape[1] <= chunk:
            return cross_entropy_logits(self.logits(params, x), targets,
                                        cfg.vocab)
        S = targets.shape[1]
        n = S // chunk
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            tot = tot + cross_entropy_logits(self.logits(params, x[:, sl]),
                                             targets[:, sl], cfg.vocab)
        loss = tot / n
        rem = S - n * chunk
        if rem:
            lg = self.logits(params, x[:, n * chunk:])
            loss = (loss * n * chunk + cross_entropy_logits(
                lg, targets[:, n * chunk:], cfg.vocab) * rem) / S
        return loss

    # ---------------------------------------------------------------- serving
    def cache_len(self, s_max: int) -> int:
        w = self.cfg.sliding_window
        return min(w, s_max) if w else s_max

    def decode_state_specs(self, B: int, s_max: int, dtype=None) -> dict:
        """Nested dict of (shape, dtype) leaves, one per decode-state leaf."""
        cfg = self.cfg
        dt = dtype or self.dtype
        KV, hd, H = cfg.kv_heads, cfg.hd, cfg.n_heads
        G = self.n_groups
        S_c = self.cache_len(s_max)
        slots = {}
        for si, slot in enumerate(self.pattern):
            key = f"slot{si}"
            if slot.mixer == "attn":
                slots[key] = {"k": ((G, B, S_c, KV, hd), dt),
                              "v": ((G, B, S_c, KV, hd), dt)}
            elif slot.mixer == "cross":
                # the patches' K and V, written once by prefill
                slots[key] = {"k": ((G, B, cfg.n_patches, KV, hd), dt),
                              "v": ((G, B, cfg.n_patches, KV, hd), dt)}
            elif slot.mixer == "mamba":
                di = cfg.mamba.expand * cfg.d_model
                slots[key] = {"conv": ((G, B, cfg.mamba.d_conv - 1, di), dt),
                              "h": ((G, B, di, cfg.mamba.d_state),
                                    torch.float32)}
            elif slot.mixer == "mlstm":
                hdu = int(cfg.xlstm.proj_factor * cfg.d_model) // H
                slots[key] = {"C": ((G, B, H, hdu, hdu), torch.float32),
                              "n": ((G, B, H, hdu), torch.float32),
                              "m": ((G, B, H), torch.float32)}
            elif slot.mixer == "slstm":
                hds = cfg.d_model // H
                slots[key] = {k: ((G, B, H, hds), torch.float32)
                              for k in ("c", "n", "h", "m")}
        return slots

    def state_logical_specs(self, B: int, s_max: int) -> dict:
        """Logical sharding of the decode state: the attention cache's
        sequence over MODEL, the batch over BATCH (the structure of
        ``decode_state_specs``)."""
        specs = {}
        for key, leaves in self.decode_state_specs(B, s_max).items():
            mixer = self.pattern[int(key.replace("slot", ""))].mixer
            specs[key] = {name: _state_logical(mixer, name)
                          for name in leaves}
        return specs

    def init_decode_state(self, B: int, s_max: int, dtype=None,
                          device="cpu") -> DecodeState:
        """The zeroed decode state of ``B`` sequences (this process's share
        of the batch) and ``s_max`` positions.  Each leaf is the rank's
        share as ``state_logical_specs`` cuts it over ``model`` (the
        attention cache's slots, Mamba's channels) where the axis divides
        the dim (``sharding.model_split``, the reference's
        ``sanitize_entry`` rule), whole otherwise."""
        logical = self.state_logical_specs(B, s_max)
        slots = {}
        for key, leaves in self.decode_state_specs(B, s_max, dtype).items():
            slots[key] = {}
            for name, (shape, dt) in leaves.items():
                shape = tuple(d // sh.model_split(d) if e == sh.MODEL else d
                              for d, e in zip(shape, logical[key][name]))
                slots[key][name] = torch.zeros(shape, dtype=dt, device=device)
        return DecodeState(slots, self.cache_len(s_max))

    def prefill(self, params, batch, s_max: int):
        """batch: {"tokens": [B, S] integer ([B, S, n_cb] with codebooks),
        and for the VLM "patches" [B, n_patches, D]}.  Returns
        (last-position logits [B, vocab] ([B, n_cb, vocab]), decode
        state).  Under a mesh ``batch`` is this process's share."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape[0], tokens.shape[1]
        if S > s_max:
            raise ValueError(f"prefill of {S} tokens with s_max={s_max}")
        device = params["embed"].device
        positions = torch.arange(S, device=device)
        caches = self.init_decode_state(B, s_max, device=device)
        # the embedding passed, not held here: it is freed once the first
        # group has run, not kept through the whole backbone
        x, _ = self._backbone(params, self.embed(params, tokens),
                              mode="prefill", positions=positions,
                              caches=caches, patches=batch.get("patches"),
                              cache_len=caches.cache_len)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        lg = self.logits(self._unembed(params), x[:, -1:])[:, 0]
        return lg[..., :cfg.vocab], caches

    def decode_step(self, params, state, token, pos: int, patches=None):
        """token [B] ([B, n_cb] with codebooks); pos the current token's
        position.  Returns (logits [B, vocab] ([B, n_cb, vocab]), state),
        the state updated in place.  ``patches`` is taken as the reference
        takes it, and unused: the cross-attention K and V are read from
        the state that prefill wrote.  ``state`` is a ``DecodeState``
        (``init_decode_state``, ``prefill``): its ``cache_len`` places the
        slots of a cache split over ``model``."""
        cfg = self.cfg
        cache_len = state.cache_len
        positions = torch.tensor([pos], device=params["embed"].device)
        # [B,1,D] ([B,1,n_cb]), passed, not held here (as in prefill)
        x, _ = self._backbone(params, self.embed(params, token[:, None]),
                              mode="decode", positions=positions,
                              caches=state, pos=pos, cache_len=cache_len)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        lg = self.logits(self._unembed(params), x[:, 0])
        return lg[..., :cfg.vocab], state


def _state_logical(mixer: str, name: str) -> tuple:
    if mixer == "attn":
        return (None, sh.BATCH, sh.MODEL, None, None)
    if mixer == "cross":
        return (None, sh.BATCH, None, None, None)
    if mixer == "mamba":
        return {"conv": (None, sh.BATCH, None, sh.MODEL),
                "h": (None, sh.BATCH, sh.MODEL, None)}[name]
    if mixer == "mlstm":
        return {"C": (None, sh.BATCH, None, None, None),
                "n": (None, sh.BATCH, None, None),
                "m": (None, sh.BATCH, None)}[name]
    return (None, sh.BATCH, None, None)                     # slstm


def token_shape(cfg: ModelConfig, *lead) -> tuple:
    """The shape of token ids with leading dims ``lead`` (e.g. B, S): one
    stream per codebook for the audio family (``[*lead, n_cb]``)."""
    return (*lead, cfg.n_codebooks) if cfg.n_codebooks else tuple(lead)


def build_model(cfg: ModelConfig) -> LM:
    return LM(cfg)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def param_count(params) -> int:
    return sum(t.numel() for _, t in _leaves(params))


def active_param_count(cfg: ModelConfig, params) -> int:
    """Active params per token (MoE: top_k of num_experts)."""
    total = param_count(params)
    if cfg.moe is None:
        return total
    expert_total = sum(t.numel() for path, t in _leaves(params)
                       if "moe" in path and path[-1] in ("w1", "w2", "w3"))
    active_frac = cfg.moe.top_k / cfg.moe.num_experts
    return total - expert_total + int(expert_total * active_frac)
