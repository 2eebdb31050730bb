"""Serving on a ``model`` mesh axis across real processes: ``gloo`` ranks on
the CPU (``launch.spmd``), spawned once for each mesh of the file, ``pod``
1 x ``data`` 1 x ``model`` 2 and ``pod`` 1 x ``data`` 2 x ``model`` 2.
Each rank serves through ``launch/serve.py::run`` with its params' shares
(``serve.build(shard=True)``, or the reference's weights cut by
``specs.shard_params``) and its process's rows of the batch: a 12-token
prompt and 4 decode steps fed given tokens (teacher forcing), batch 4,
float32.  The decode state is held as ``state_logical_specs`` cuts it:
the attention cache's slots over ``model`` (merged by flash-decoding),
Mamba's channels over ``model``, the batch over ``data``.

The zoo, every family ``reduced()``: granite and a 16-head variant of it
(``attn_tp`` splits the query heads, which decode gathers before it
attends), gemma (one KV head), starcoder2 with a window of 8 (the ring
wraps during decode, as in tests/test_decode_consistency.py), Qwen3-MoE,
the Jamba (the scan on the rank's channels, the experts over ``model``),
xLSTM, the VLM (its cross cache whole over ``model``) and MusicGen
(codebooks); and granite with a 2-token prompt in a cache of 8, where the
second shard holds no valid slot in the first decode steps.

Held, on every rank: the logits (gathered whole over the batch axes)
within 1e-5 of the largest |logit| of the same run with no mesh here, and
every decode-state leaf within 1e-5 of the no-mesh state cut as the specs
say (``specs.shard_state``); granite, the Jamba and the VLM, on the
reference's own init, within 1e-4 of the JAX reference's ``prefill`` and
``decode_step``; each rank's decode-state bytes and param bytes equal to
``dryrun.per_device_bytes`` of the state and of the params on the same
mesh (the params cut over ``data`` too where it is 2: FSDP, each slot's
weights gathered just before it runs, the MoE's expert F gathered in
prefill and left cut in decode, whose partial sums are added over
``data``); a sampled run
(temperature 1) draws the same tokens on every rank and as no mesh does;
each rank's collective bytes by kind over ``serve.run`` equal the dry
run's count of the same run on its rank (``dryrun.serve_collectives``).
The MoE's capacity is reckoned from the local token count in prefill and
from the gathered count in decode, as in the reference; the reduced MoE
configs (4 experts, top 2, capacity factor 2) give every expert a capacity
of at least the tokens routed, so nothing drops under either count and the
mesh can be held against no mesh (the test asserts so).

The JAX package is imported inside the reference fixture, not at the top:
the spawned ranks import this module, and need only the port."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.convert import tree_from_jax
from repro_torch.launch import dryrun, serve, spmd
from repro_torch.launch import specs as sp
from repro_torch.models import build_model, token_shape
from repro_torch.models import sharding as sh

B = 4
TOL, REF_TOL = 1e-5, 1e-4
MESHES = {"1x1x2": (1, 1, 2), "1x2x2": (1, 2, 2)}
CASES = {   # name: (arch, config changes, prompt, decode steps)
    "granite": ("granite-3-2b", {}, 12, 4),
    "granite 16 heads": ("granite-3-2b", dict(n_heads=16, kv_heads=4,
                                              head_dim=16), 12, 4),
    "gemma": ("gemma-2b", {}, 12, 4),
    "starcoder2 window 8": ("starcoder2-7b", dict(sliding_window=8), 12, 4),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}, 12, 4),
    "jamba": ("jamba-1.5-large-398b", {}, 12, 4),
    "xlstm": ("xlstm-125m", {}, 12, 4),
    "vlm": ("llama-3.2-vision-90b", {}, 12, 4),
    "musicgen": ("musicgen-medium", {}, 12, 4),
    "granite short prompt": ("granite-3-2b", {}, 2, 6),
}
# on the reference's own init, against its prefill and decode_step
JAX_CASES = ("granite", "jamba", "vlm")


def config(name):
    arch, kw, _, _ = CASES[name]
    return reduced(get_config(arch)).replace(**kw)


def inputs(cfg, S0, T):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, token_shape(cfg, B, S0 + T))
    patches = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
               .astype(np.float32) if cfg.cross_attn_every else None)
    return toks, patches


def jax_weights(name):
    """The reference's init of the case's config, as the port's nested
    params (numpy leaves), and the reference's model and params."""
    import jax
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models import build_model as jbuild
    arch, kw, _, _ = CASES[name]
    jm = jbuild(jreduced(jget_config(arch)).replace(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    return tree_from_jax(jax.tree.map(np.asarray, jp)), jm, jp


def to_plain(tree):
    return {k: to_plain(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def serve_case(name, weights=None):
    """The case through ``serve.run`` on this process (its mesh, or
    none): (logits, decode state, param bytes, collective bytes by
    kind)."""
    cfg = config(name)
    _, _, S0, T = CASES[name]
    if weights is None:
        model, params = serve.build(cfg, "cpu", seed=0,
                                    shard=sh.get_mesh() is not None)
    else:
        model = build_model(cfg)
        params = sp.shard_params(weights, model.logical_specs)
    toks, patches = inputs(cfg, S0, T)
    with sh.count_collectives() as counts:
        res = serve.run(model, params, toks[:, :S0], T, 0.0,
                        torch.Generator(), patches, forced=toks[:, S0:])
    return (res.logits, to_plain(res.state), sp.param_bytes(params),
            dict(counts))


def sampled_ids():
    cfg = config("granite")
    model, params = serve.build(cfg, "cpu", seed=0,
                                shard=sh.get_mesh() is not None)
    toks, _ = inputs(cfg, 12, 0)
    return serve.run(model, params, toks, 6, 1.0,
                     torch.Generator().manual_seed(5)).ids


def rank_main(mesh, weights):
    torch.use_deterministic_algorithms(True)
    out = {name: serve_case(name, weights.get(name)) for name in CASES}
    for name, (_, _, S0, T) in CASES.items():
        out["dry", name] = dryrun.serve_collectives(config(name), mesh, B,
                                                    S0, T)
    ids = sampled_ids()
    out["sampled"] = (ids, sh.replica_checksums(
        {"ids": torch.from_numpy(ids)}))
    return out


@pytest.fixture(scope="module")
def references():
    """No mesh: every case's run, the sampled ids; the reference's
    teacher-forced logits for JAX_CASES, and their weights."""
    import jax
    import jax.numpy as jnp
    weights, jax_logits = {}, {}
    for name in JAX_CASES:
        weights[name], jm, jp = jax_weights(name)
        cfg = config(name)
        _, _, S0, T = CASES[name]
        toks, patches = inputs(cfg, S0, T)
        extra = {} if patches is None else {"patches": jnp.asarray(patches)}
        lg, state = jax.jit(lambda p, x: jm.prefill(
            p, {"tokens": x, **extra}, S0 + T))(
            jp, jnp.asarray(toks[:, :S0], jnp.int32))
        out = [np.asarray(lg)]
        dec = jax.jit(jm.decode_step)
        for i in range(T):
            lg, state = dec(jp, state, jnp.asarray(toks[:, S0 + i],
                                                   jnp.int32),
                            jnp.int32(S0 + i), extra.get("patches"))
            out.append(np.asarray(lg))
        jax_logits[name] = out
    # these tiny runs take 50-100x longer on many threads than on one
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {name: serve_case(name, weights.get(name)) for name in CASES}
        sampled = sampled_ids()
    finally:
        torch.set_num_threads(threads)
    return dict(weights=weights, jax=jax_logits, runs=runs, sampled=sampled)


@pytest.fixture(scope="module", params=sorted(MESHES))
def ranks(request, references, tmp_path_factory):
    mesh = request.param
    return mesh, spmd.run(
        rank_main, (references["weights"],), sizes=MESHES[mesh],
        device="cpu", init_method=spmd.init_file(
            tmp_path_factory.mktemp(f"serve_{mesh}")),
        all_ranks=True, verbose=False, timeout_s=300)


def rank_mesh(mesh, rank):
    sizes = MESHES[mesh]
    return sh.Mesh(("pod", "data", "model"), sizes,
                   tuple(range(int(np.prod(sizes)))), rank=rank)


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_served_logits_and_state_match_no_mesh(ranks, references, name):
    mesh, got = ranks
    want_logits, want_state, _, _ = references["runs"][name]
    model = build_model(config(name))
    _, _, S0, T = CASES[name]
    logical = model.state_logical_specs(B, S0 + T)
    for rank, out in enumerate(got):
        logits, state, _, _ = out[name]
        assert len(logits) == T + 1
        for i, (g, w) in enumerate(zip(logits, want_logits)):
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert rel(g, w) <= TOL, (mesh, rank, i, rel(g, w))
        want = sp.shard_state(want_state, logical, rank_mesh(mesh, rank))
        assert state.keys() == want.keys()
        for key in want:
            for leaf in want[key]:
                g, w = state[key][leaf], want[key][leaf]
                assert g.shape == w.shape, (mesh, rank, key, leaf)
                assert float((g - w).abs().max()) <= TOL * max(
                    float(w.abs().max()), 1.0), (mesh, rank, key, leaf)


@pytest.mark.parametrize("name", JAX_CASES)
def test_served_logits_match_the_reference(ranks, references, name):
    mesh, got = ranks
    for rank, out in enumerate(got):
        assert len(out[name][0]) == len(references["jax"][name])
        for i, (g, w) in enumerate(zip(out[name][0],
                                       references["jax"][name])):
            gap = rel(g, torch.from_numpy(np.array(w)))
            assert gap <= REF_TOL, (mesh, rank, i, gap)


def test_state_and_param_bytes_are_the_dry_runs(ranks):
    mesh, got = ranks
    for name in CASES:
        cfg = config(name)
        model = build_model(cfg)
        _, _, S0, T = CASES[name]
        whole = model.init_decode_state(B, S0 + T, device="meta")
        logical = model.state_logical_specs(B, S0 + T)
        for rank, out in enumerate(got):
            rm = rank_mesh(mesh, rank)
            held = sum(v.numel() * v.element_size()
                       for leaves in out[name][1].values()
                       for v in leaves.values())
            assert held == dryrun.per_device_bytes(whole, logical, rm), (
                mesh, name, rank)
            assert out[name][2] == dryrun.per_device_bytes(
                model.param_specs(), model.logical_specs, rm), (
                mesh, name, rank)
    # nothing drops in the MoE configs: capacity >= the tokens routed
    for name in ("qwen3-moe", "jamba"):
        moe = config(name).moe
        assert moe.top_k * moe.capacity_factor >= moe.num_experts


def test_sampled_tokens_agree_across_ranks(ranks, references):
    mesh, got = ranks
    for rank, out in enumerate(got):
        ids, sums = out["sampled"]
        assert len(set(sums["ids"])) == 1, (mesh, rank)
        np.testing.assert_array_equal(ids, references["sampled"])


@pytest.mark.parametrize("name", list(CASES))
def test_served_collective_bytes_are_the_dry_runs(ranks, name):
    mesh, got = ranks
    for rank, out in enumerate(got):
        live, dry = out[name][3], out["dry", name]
        assert live and live == dry, (mesh, rank, live, dry)
