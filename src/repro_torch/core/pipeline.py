"""The update pipeline, mirroring ``repro/core/pipeline.py``: one stage
stack, built once from ``FLConfig``, that every execution mode, sync and
async, folds its client updates through.

Stages over update dicts plus per-slot scalars; a "slot" is one client
update in a batch of K (a sync cohort, an async commit buffer, or the pods
of a round):

    compress -> weight/discount -> secure_mask -> aggregate -> normalise

``client_weights`` gives ``(w_eff, w_raw)``: the data-size weights times
the participation mask (times the inverse loss under
aggregation='weighted'), and, async only, ``w_eff`` times the staleness
discount ``1/(1+s)^a``.  The sum is normalised by the UN-discounted mass
``w_raw.sum()``, so a uniformly stale buffer takes a proportionally smaller
server step (FedBuff) instead of having the discount cancel in the mean.
Masking follows weighting: the server sums ``w_i * d_i + m_i`` and the
``m_i`` cancel only if nothing scales them per slot afterwards.

Execution-mode mapping:
  * parallel / async commit — ``combine`` consumes the full [K, ...] stack
    (trimmed mean and the hierarchical pod combine included); the chunked
    async commit sums ``combine_unnormalised`` over chunks;
  * sequential — per-slot ``contribution`` folded with ``accum_add``, then
    ``normalise``: the same algebra in streaming memory;
  * pod_sequential / hierarchical — per-pod partial sums, compressed, then
    combined across pods by ``combine_pods``.

Fused commit path (``compression.use_fused``, default on): every stage
between compress and normalise is elementwise or a slot reduction, so the
batched combinator runs them as one CUDA kernel over a bucket of all leaves
(``kernels/ops.fused_*_tree``):
  * deterministic quantize and/or top-k -> ``plain_commit`` (top-k +
    per-slot-block quantize + weighted sum);
  * no compression -> ``fused_accum``;
  both take the raw weights, the staleness and the exponent, and compute
  the discount in the kernel;
  * stochastic rounding or federated dropout need per-slot randomness, so
    compression runs per slot first (top-k and the deterministic quantize
    through their CUDA kernels) and only the accumulate fuses;
  * secure aggregation with quantization -> ``secure_commit`` (below), in
    both rounding modes; without quantization the masks stay float-domain;
  * the streaming and pod-local compress stages route per-slot top-k and
    deterministic quantize through their kernels: there is no slot batch
    to fuse across.
``--no-use-fused`` runs the plain stages (and the secure commit's plain
version).

Secure aggregation (``cfg.secure_agg``, ``core/secure_agg.py``): each
commit draws one uint32 commit key from the run's generator
(``mask_key``); slot ids are the per-commit slot indices.  With
``quantize_bits`` the commit quantizes every slot's weighted values onto
ONE commit-common per-block grid, adds uint32 modular pairwise mask words
to the int32 wire words, and sums: the masks cancel exactly and the sum
dequantizes through the common scale (``_fused_secure``).  The streaming
(sequential) and cross-pod paths keep float-domain masks: a stream sees one
slot at a time and pods quantize on per-pod grids, so neither has a common
grid.  ``secure_agg`` with ``trimmed_mean`` is refused when the pipeline is
built: coordinate-wise trimming needs the individual updates that masking
hides.

Under a mesh of processes (``models.sharding``), the slot dim of a batched
stage may arrive split over ``slot_axes`` (a parallel round's clients, a
pod_sequential round's pods): each process holds its contiguous share of
the slots, ``[K/n, ...]``, and of the [K] weights, mask, losses and
staleness.  ``client_weights`` gets the vectors all-gathered (whole [K] on
every process); the fused kernels and the unfused weighted sum run on this
process's rows of all K slots after one ``all_to_all``
(``kernels/ops.rows_reduce``), so fused and unfused differ only as they do
with no mesh; the per-slot compress runs on the process's own slots, each
random draw made whole on every process and cut to its share, so a split
commit draws what the unsplit one does; float-domain secure masks are
added to the process's own slots, and the masked slots are gathered and
summed in slot order; trimming and the hierarchical pod combine gather the
slots whole first.  The streaming stages take whole (replicated) slots.

Where the params are cut over ``data`` and ``model`` at rest
(``launch.specs.shard_params``), so are the deltas: ``model_commit`` runs
a stage on each rank's shares, the cutting axes dropped from the fusion
axes.  An elementwise commit (no compression, no secure masks:
``fused_accum``, the plain weighted sum, the streaming sum, the trimmed
mean) needs nothing more.  A blockwise one (quantize, top-k, dropout, the
secure commits) runs blocks along each leaf's last dim, and its draws and
masks follow the whole leaf's element order.  A share whose blocks are
whole blocks of the whole leaf (``block_aligned``: a leading dim cut, or
a last dim cut into shares that are multiples of the block) runs as it
is: the row kernels are block-local, every random draw (rounding noise,
dropout columns, float-domain pair masks) is made over the whole leaf,
one leaf at a time, and cut to the share, and the integer secure commit
masks each element at its index in the whole bucket (a row table,
``kernels.ops.row_table``).  A leaf whose blocks straddle a shard (a last
dim cut into shares that are not multiples of the block) is gathered
whole along its last dim first, over the axes that cut it, and its result
cut back to the rank's share (``sharding.count_commit_gathers`` counts
these leaves); a cut of another of its dims stays a share.  So a cut
commit equals the uncut commit of the same deltas bit for bit, and a
rank's commit transient is its share of the model, the straddling leaves
whole along their last dims.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import secure_agg as sec
from repro_torch.core.compression import compress_tree
from repro_torch.kernels import ops as kops
from repro_torch.models import sharding as sh
from repro_torch.pytree import ordered

if TYPE_CHECKING:                       # avoid circular import with round.py
    from repro_torch.core.round import FLConfig


def cuts_over(cuts: dict, axes) -> dict:
    """``cuts`` (``{leaf: {axis: dim}}``) restricted to ``axes``."""
    out = {k: {a: d for a, d in c.items() if a in axes}
           for k, c in cuts.items()}
    return {k: c for k, c in out.items() if c}


def cuts_whole(tree: dict, cuts: dict, lead: int = 0) -> dict:
    """Each leaf of ``tree`` that ``cuts`` cuts (after ``lead`` leading
    slot dims) gathered whole over its axes; the rest as they are.  The
    axes are gathered in the reverse of the order ``cuts_share`` cuts
    them, so that a dim cut over two axes comes back in order."""
    out = {}
    for k, v in tree.items():
        for a, d in reversed(list(cuts.get(k, {}).items())):
            v = sh.all_gather(v, a, d + lead)
        out[k] = v
    return out


def cuts_share(tree: dict, cuts: dict, lead: int = 0) -> dict:
    """``cuts_whole``'s inverse: this rank's share of each cut leaf."""
    out = {}
    for k, v in tree.items():
        for a, d in cuts.get(k, {}).items():
            v = sh.local_share(v, a, d + lead, k)
        out[k] = v
    return out


def share_cut(cut: dict) -> tuple:
    """A leaf's ``{axis: dim}`` cut as this rank's share, in
    ``sharding.shard_cut``'s form (``(dim, index, count)``): the axes that
    cut one dim combined in the order ``launch.specs.shard_leaf`` cuts
    them (``cuts_share`` too)."""
    mesh = sh.get_mesh()
    out = {}
    for a, d in cut.items():
        i, n = out.get(d, (0, 1))
        out[d] = (i * mesh.shape[a] + mesh.coords[a], n * mesh.shape[a])
    return tuple((d, i, n) for d, (i, n) in out.items())


def block_aligned(shape, cut: dict, block: int) -> bool:
    """Whether every block of a leaf's share is a whole block of the whole
    leaf: ``shape`` the share's (no slot dims), ``cut`` its ``{axis:
    dim}``.  Blocks run along the last dim, so a cut of another dim moves
    whole blocks; a cut of the last dim does where the share's length
    there is a multiple of ``block``: the share then starts on a block
    boundary of the whole leaf, and no padding falls inside it."""
    last = len(shape) - 1
    return all(d != last or shape[last] % block == 0 for d in cut.values())


def staleness_weights(staleness, exponent):
    """The FedBuff polynomial discount ``1 / (1 + s)^a``.  ``staleness``
    counts server commits between a client's dispatch and its update's
    arrival; works on tensors and numpy arrays.  ``exponent`` is a runtime
    number: the adaptive controller moves it between commits."""
    return (1.0 + staleness) ** (-exponent)


class UpdatePipeline:
    """The configured stage stack.  Stateless; one instance serves every
    round of a run."""

    def __init__(self, cfg: "FLConfig", n_pods: int = 1,
                 allow_fused: bool = True):
        if cfg.secure_agg and cfg.aggregation == "trimmed_mean":
            raise ValueError(
                "secure_agg is incompatible with aggregation='trimmed_mean': "
                "coordinate-wise trimming needs the individual updates that "
                "pairwise masking hides; use fedavg/weighted")
        comp = cfg.compression
        self.fused = bool(comp.use_fused) and allow_fused
        # fully-fusable compression: deterministic rounding, no per-slot
        # dropout randomness
        self._fusable_comp = (not comp.dropout_frac
                              and not (comp.quantize_bits
                                       and comp.stochastic_rounding))
        if self.fused and comp.enabled and not comp.use_kernels:
            # per-slot compress stages (streaming, pod-local, stochastic)
            # route through the CUDA compress kernels under fusion
            cfg = dataclasses.replace(
                cfg, compression=dataclasses.replace(comp, use_kernels=True))
        self.cfg = cfg
        self.n_pods = n_pods
        self.accum_dtype = getattr(torch, cfg.accum_dtype)

    # ------------------------------------------------------- model shares
    @property
    def blockwise(self) -> bool:
        """Whether a commit stage works in blocks along each leaf's last
        dim: compression (blocks, dropout's columns, rounding draws in
        element order) or secure masks (indexed by element)."""
        return self.cfg.compression.enabled or self.cfg.secure_agg

    def model_commit(self, fn: Callable, tree: dict, cuts=None,
                     lead: int = 1):
        """``fn(tree)``, a commit stage whose result is a dict of leaves
        (or a tuple led by one), on a ``tree`` of this rank's shares over
        ``data`` and ``model``: ``cuts`` gives each cut leaf's dims
        (``{leaf: {axis: dim}}``, ``launch.specs.leaf_cuts``' form), after
        ``lead`` leading slot dims.  The stage runs with the cutting axes
        out of the fusion axes, on the shares (``sharding.leaf_shares``:
        its draws and masks follow the whole leaves), but for a blockwise
        stage's leaves whose blocks straddle a shard (not
        ``block_aligned``): those go in gathered whole along their last
        dim, over the axes that cut it (a cut of another dim stays a
        share), and their result comes out cut back.  The result is the
        uncut stage's on the whole leaves, cut, bit for bit."""
        cuts = cuts_over(cuts or {}, [a for a in (sh.DATA, sh.MODEL)
                                      if sh.axis_live(a)])
        if not cuts:
            return fn(tree)
        block = self.cfg.compression.block
        gather, shares = {}, {}
        for k, c in cuts.items():
            if k not in tree:
                continue
            shape = tree[k].shape[lead:]
            if self.blockwise and not block_aligned(shape, c, block):
                # whole along the last dim; a cut of another dim stays
                gather[k] = {a: d for a, d in c.items()
                             if d == len(shape) - 1}
                sh.note_commit_gather(k)
            rest = {a: d for a, d in c.items() if a not in gather.get(k, {})}
            if rest:
                shares[k] = share_cut(rest)
        tree = cuts_whole(tree, gather, lead)
        with sh.exclude_axes(*{a for c in cuts.values() for a in c}), \
                sh.leaf_shares(shares):
            out = fn(tree)
        if not gather:
            return out
        if isinstance(out, tuple):
            return (cuts_share(out[0], gather),) + out[1:]
        return cuts_share(out, gather)

    # ------------------------------------------------------------- slots
    @staticmethod
    def gather_slots(*vectors, slot_axes=()):
        """Per-slot vectors (or None) whole: each all-gathered over
        ``slot_axes`` in shard order."""
        return tuple(None if v is None else sh.all_gather(v, slot_axes, 0)
                     for v in vectors)

    @staticmethod
    def gather_stack(stacked: dict, slot_axes=()) -> dict:
        """A [K/n, ...] slot stack whole, [K, ...], on every process."""
        return {k: sh.all_gather(d, slot_axes, 0) for k, d in stacked.items()}

    # ------------------------------------------------------------- stage 1
    def compress(self, tree: dict, generator) -> dict:
        return compress_tree(tree, self.cfg.compression, generator,
                             shares=sh.current_shares())

    def compress_each(self, stacked: dict, generator, slot_axes=()) -> dict:
        """The compress stage over every slot of a [K, ...] stack at once:
        blocks are per row, and dropout draws one mask per slot.  Slots
        split over ``slot_axes`` compress where they are, the row kernels
        split over the axes the slots are whole along."""
        with sh.exclude_axes(*slot_axes):
            return compress_tree(stacked, self.cfg.compression, generator,
                                 batch_dims=1, cut=sh.shard_cut(slot_axes),
                                 shares=sh.current_shares())

    # ------------------------------------------------------------- stage 2
    def client_weights(self, weights, mask, losses=None, staleness=None,
                       exponent=None):
        """(w_eff, w_raw): the discounted and the raw per-slot weights.
        ``w_raw`` is data sizes x participation (x inverse loss under
        aggregation='weighted'); without staleness ``w_eff`` is ``w_raw``."""
        w_raw = agg.effective_weights(weights, mask, losses,
                                      self.cfg.aggregation)
        if staleness is None:
            return w_raw, w_raw
        return w_raw * staleness_weights(staleness.to(torch.float32),
                                         exponent), w_raw

    def client_weight(self, w_c, m_c, loss_c):
        """Scalar form for streaming callers."""
        return agg.effective_weights(w_c[None], m_c[None], loss_c[None],
                                     self.cfg.aggregation)[0]

    # ------------------------------------------------------------- stage 3
    def mask_key(self, generator) -> int:
        """This commit's uint32 mask key: one draw from the run's generator,
        folded with the mask domain tag.  Every commit draws a fresh key, so
        replaying a run (or resuming it) needs the generator's state."""
        draw = torch.randint(0, 2 ** 32, (), generator=generator,
                             device=generator.device)
        return sec.commit_key(int(draw))

    def secure_mask(self, weighted_stack: dict, key: int, ids,
                    participation, first: int = 0) -> dict:
        return sec.mask_batch(weighted_stack, key, ids, participation,
                              first, shares=sh.current_shares())

    # --------------------------------------------------------- stages 4/5
    def weighted_sum(self, stacked: dict, w, slot_axes=()) -> dict:
        """sum_i w_i * d_i over the slot dim, in float32: the unfused
        commit's sum.  Off a mesh, leaf by leaf; under one (slots whole or
        split over ``slot_axes``), on this process's rows of the fused
        commit's blocked layout (``kernels.ops.weighted_sum_tree``), as the
        fused kernels run.  The two agree bit for bit (``chip_compare.py
        --spmd`` on an H100); leaf by leaf spares the pack's copy, 0.26
        against 0.53 ms over the CIFAR CNN's stack of 20 slots there."""
        if not sh.fusion_axes():
            return {k: (d.to(torch.float32) * w.reshape(
                (-1,) + (1,) * (d.ndim - 1)).to(torch.float32)).sum(0)
                for k, d in stacked.items()}
        names = ordered(stacked)
        return dict(zip(names, kops.weighted_sum_tree(
            [stacked[n] for n in names], w, block=self.cfg.compression.block,
            slot_axes=slot_axes)))

    def normalise(self, summed: dict, w_sum) -> dict:
        denom = torch.clamp(w_sum, min=1e-12)
        return {k: s / denom.to(s.dtype) for k, s in summed.items()}

    # ----------------------------------------------------------- streaming
    def accum_init(self, params_like: dict) -> dict:
        return {k: torch.zeros(p.shape, dtype=self.accum_dtype,
                               device=p.device)
                for k, p in params_like.items()}

    def contribution(self, delta: dict, wt, generator, idx=None, ids=None,
                     participation=None, key=None) -> dict:
        """One slot's contribution to the running sum: compress -> weight ->
        (secure-mask).  The masked value is what crosses the wire; the masks
        cancel once every participant's contribution is folded in.  The
        weighting product is carried in ``accum_dtype``."""
        dt = self.accum_dtype
        d = self.compress(delta, generator)
        pre = {k: wt.to(dt) * x.to(dt) for k, x in d.items()}
        if self.cfg.secure_agg:
            pre = sec.mask_slot(key, ids, participation, idx, pre,
                                shares=sh.current_shares())
        return pre

    def accum_add(self, acc: dict, contrib: dict) -> dict:
        return {k: a + contrib[k].to(a.dtype) for k, a in acc.items()}

    # --------------------------------------------------------- combinators
    def combine_unnormalised(self, deltas: dict, weights, mask, losses,
                             generator, ids=None, staleness=None,
                             exponent=None, slot_axes=()):
        """compress -> weight/discount -> (secure_mask) -> weighted sum,
        WITHOUT the closing normalise.  Returns (summed, w_eff, w_raw,
        (mask, losses)), the weights, mask and losses whole.

        Every stage up to normalise is slot-local or additive, so a commit
        over K slots equals the sum of this over any partition of the slots
        into chunks, normalised once by the total raw mass: the algebra of
        the chunked async commit.  Each chunk draws its own randomness (and
        mask key) from ``generator``, so masks cancel within each chunk.  A
        sync commit has no staleness: the fused kernels get zero staleness
        and exponent 0, a discount of exactly 1.  ``slot_axes``: the mesh
        axes the slots (``deltas`` and the vectors) are split over."""
        if self.cfg.aggregation == "trimmed_mean":
            raise ValueError(
                "trimmed_mean is not a chunk-accumulable aggregate: "
                "coordinate-wise trimming needs all slots at once")
        weights, mask, losses, staleness = self.gather_slots(
            weights, mask, losses, staleness, slot_axes=slot_axes)
        w_eff, w_raw = self.client_weights(weights, mask, losses, staleness,
                                           exponent)
        comp = self.cfg.compression
        names = ordered(deltas)
        if self.cfg.secure_agg:
            if ids is None:
                ids = torch.arange(mask.shape[0], dtype=torch.int32)
            if comp.quantize_bits:
                summed = self._fused_secure(deltas, w_eff, mask, generator,
                                            ids, slot_axes)
            else:
                stacked = (self.compress_each(deltas, generator, slot_axes)
                           if comp.enabled else deltas)
                w_loc = sh.local_share(w_eff, slot_axes)
                pre = {k: d.to(torch.float32) * w_loc.reshape(
                    (-1,) + (1,) * (d.ndim - 1)) for k, d in stacked.items()}
                masked = self.secure_mask(
                    pre, self.mask_key(generator), ids, mask,
                    first=sh.shard_index(slot_axes) * w_loc.shape[0])
                masked = self.gather_stack(masked, slot_axes)
                summed = {k: m.to(torch.float32).sum(0)
                          for k, m in masked.items()}
        elif self.fused:
            # the kernels take the raw weights and compute the discount
            s = (staleness.to(torch.float32) if staleness is not None
                 else torch.zeros_like(w_raw))
            a = float(exponent) if exponent is not None else 0.0
            if comp.enabled and self._fusable_comp:
                # one pass: top-k + quantize + discount + sum, all leaves
                # bucketed into a single kernel launch
                out = kops.fused_plain_commit_tree(
                    [deltas[n] for n in names], w_raw, s, a,
                    bits=comp.quantize_bits, k=comp.topk_k, block=comp.block,
                    slot_axes=slot_axes)
            else:
                # per-slot stages that need slot randomness stay unfused;
                # the accumulate still fuses (one bucketed launch)
                stacked = (self.compress_each(deltas, generator, slot_axes)
                           if comp.enabled else deltas)
                out = kops.fused_accum_tree([stacked[n] for n in names],
                                            w_raw, s, a, block=comp.block,
                                            slot_axes=slot_axes)
            summed = dict(zip(names, out))
        else:
            stacked = (self.compress_each(deltas, generator, slot_axes)
                       if comp.enabled else deltas)
            summed = self.weighted_sum(stacked, w_eff, slot_axes)
        return summed, w_eff, w_raw, (mask, losses)

    def _fused_secure(self, deltas: dict, w, participation, generator,
                      ids, slot_axes=()) -> dict:
        """Integer-domain secure commit (secure_agg + quantize_bits): one
        bucketed ``secure_commit`` launch for the whole tree, or its plain
        version with fusion off; both compute the same scheme."""
        comp = self.cfg.compression
        key = self.mask_key(generator)
        seeds = sec.pair_seeds(key, ids)
        coef = sec.pair_coef_int(ids, participation)
        stacked, k_in = deltas, comp.topk_k
        shares = sh.current_shares()
        if comp.dropout_frac:
            # dropout draws per-slot randomness and must precede top-k, so
            # both run as per-slot pre-stages (the quantize stays in the
            # integer-domain masked commit)
            pre = dataclasses.replace(comp, quantize_bits=0)
            with sh.exclude_axes(*slot_axes):
                stacked = compress_tree(stacked, pre, generator,
                                        batch_dims=1,
                                        cut=sh.shard_cut(slot_axes),
                                        shares=shares)
            k_in = 0
        names = ordered(stacked)
        out = kops.fused_secure_commit_tree(
            [stacked[n] for n in names], w, seeds, coef,
            bits=comp.quantize_bits, k=k_in, block=comp.block,
            use_kernel=self.fused,
            noise_generator=generator if comp.stochastic_rounding else None,
            slot_axes=slot_axes, cuts=[shares.get(n, ()) for n in names])
        return dict(zip(names, out))

    def combine(self, deltas: dict, weights, mask, losses, generator,
                ids=None, staleness=None, exponent=None, slot_axes=()):
        """The full batched stack over [K, ...] slot deltas: the parallel
        sync mode (staleness=None) and the async buffered commit (staleness
        and exponent set), the trimmed mean and the hierarchical pod combine
        included.  Returns (delta, w_eff, w_raw, (mask, losses)), the
        weights, mask and losses whole; the sum is normalised by
        ``w_raw.sum()``, not by ``w_eff``.  ``slot_axes``: the mesh axes the
        slots are split over."""
        if self.cfg.aggregation == "trimmed_mean" or (
                self.cfg.hierarchical and self.n_pods > 1):
            # both need every slot at once: gathered whole
            deltas = self.gather_stack(deltas, slot_axes)
            weights, mask, losses, staleness = self.gather_slots(
                weights, mask, losses, staleness, slot_axes=slot_axes)
            w_eff, w_raw = self.client_weights(weights, mask, losses,
                                               staleness, exponent)
            if self.cfg.aggregation == "trimmed_mean":
                # robust trimming consumes the RAW per-slot deltas (no
                # compression, no masking: refused at build time)
                return (agg.trimmed_mean(deltas, mask), w_eff, w_raw,
                        (mask, losses))
            return (self._combine_hierarchical(deltas, w_eff, w_raw,
                                               generator), w_eff, w_raw,
                    (mask, losses))
        summed, w_eff, w_raw, whole = self.combine_unnormalised(
            deltas, weights, mask, losses, generator, ids=ids,
            staleness=staleness, exponent=exponent, slot_axes=slot_axes)
        return self.normalise(summed, w_raw.sum()), w_eff, w_raw, whole

    def _combine_hierarchical(self, deltas: dict, w_eff, w_raw,
                              generator) -> dict:
        """Pod-local weighted sums -> compress -> cross-pod combine: only
        the compressed pod sums cross the slow cross-pod link."""
        P = self.n_pods
        per_pod = w_eff.shape[0] // P

        def pod_sums(d):
            wb = w_eff.reshape((P, per_pod) + (1,) * (d.ndim - 1)).to(d.dtype)
            return (d.reshape((P, per_pod) + tuple(d.shape[1:])) * wb).sum(1)

        sums = {k: pod_sums(d) for k, d in deltas.items()}
        return self.combine_pods(sums, w_raw.sum(), generator)

    def combine_pods(self, pod_sums: dict, w_total, generator,
                     compressed: bool = False, slot_axes=()) -> dict:
        """Cross-pod tail of the stack: compress each pod's partial sum
        (unless the caller did), secure-mask BETWEEN PODS (each pod's
        aggregate hidden from the others and the server), sum, normalise by
        the total raw weight mass.  ``slot_axes``: the mesh axes the pods
        are split over."""
        names = ordered(pod_sums)
        P_loc = pod_sums[names[0]].shape[0]
        P = P_loc * sh.shard_count(slot_axes)
        sums = (pod_sums if compressed
                else self.compress_each(pod_sums, generator, slot_axes))
        if self.cfg.secure_agg:
            # float-domain even under quantization: the pod sums were
            # quantized on per-pod grids, so there is no common grid for
            # integer masks to cancel on
            ones = torch.ones(P, dtype=torch.float32)
            masked = self.secure_mask(sums, self.mask_key(generator),
                                      torch.arange(P, dtype=torch.int32),
                                      ones,
                                      first=sh.shard_index(slot_axes) * P_loc)
            masked = self.gather_stack(masked, slot_axes)
            summed = {k: m.to(torch.float32).sum(0)
                      for k, m in masked.items()}
        elif self.fused:
            dev = sums[names[0]].device
            out = kops.fused_accum_tree(
                [sums[n] for n in names],
                torch.ones(P, dtype=torch.float32, device=dev),
                torch.zeros(P, dtype=torch.float32, device=dev), 0.0,
                block=self.cfg.compression.block, slot_axes=slot_axes)
            summed = dict(zip(names, out))
        else:
            summed = self.weighted_sum(
                sums, torch.ones(P, dtype=torch.float32,
                                 device=sums[names[0]].device), slot_axes)
        return self.normalise(summed, w_total)


def build_update_pipeline(cfg: "FLConfig", n_pods: int = 1,
                          allow_fused: bool = True) -> UpdatePipeline:
    """Build the stage stack once from FLConfig; every execution mode of
    ``core/round.py`` and ``core/async_round.py`` closes over the returned
    pipeline.  ``allow_fused=False`` forces the unfused stages."""
    return UpdatePipeline(cfg, n_pods=n_pods, allow_fused=allow_fused)
