"""The dry run's memory analysis (``launch/dryrun.py``'s
``memory_analysis``), counted from the port's own allocations
(``launch.memory.count_memory``) on ``meta`` tensors:

* a hand-reckoned step (two matrix products, their backward, an in-place
  update): its argument, output, temp and alias bytes and the backward's
  peak equal the reckoning to the byte, the CUDA caching allocator's
  512-byte rounding included, on ``meta`` and on CPU tensors alike, and
  under ``torch.func.vmap`` of ``grad``;
* a prefill and a decode step of the reduced dense, MoE and hybrid
  configs with no mesh: the argument and output bytes equal the
  reference's ``compiled.memory_analysis()`` of the same call on one CPU
  device, less what XLA alone counts: the decode's int32 position, which
  the port passes as a host integer, and the output tuple's index table
  (one 8-byte pointer an output leaf).  Temp is compared with nothing (XLA
  fuses); the reference donates nothing, so its alias is 0, and the port's
  decode updates its state in place: its alias is the state's bytes;
* every kernel wrapper on ``meta`` charges what its CUDA branch allocates
  (its outputs, and the secure commit's scratch while it runs), reckoned
  from the code, launches nothing, and on the CPU under a count is
  charged the same;
* the depth check: for one arch of each family and each shape kind, the
  count at four layer groups (scaled from one and two where three lie on
  their line, else counted whole) equals the count of the step at four
  groups;
* a tag's JSON carries ``memory_analysis`` under the reference's key
  names, with its ``note``, and the CLI writes a failing tag's error and
  goes on with the grid."""
import importlib
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild
from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.core import build_fl_round_step
from repro_torch.kernels import launches
from repro_torch.kernels.fedprox_update import fedprox_update_flat
from repro_torch.kernels.fused_accum import fused_accum_blocks
from repro_torch.kernels.fused_quant_mask import (plain_commit_blocks,
                                                  secure_commit_blocks)
from repro_torch.kernels.quantize import quantize_dequant_blocks
from repro_torch.kernels.selective_scan import (
    selective_scan_chunk_blocks, selective_scan_chunk_bwd_blocks)
from repro_torch.kernels.topk_sparsify import topk_sparsify_blocks
from repro_torch.launch import dryrun
from repro_torch.launch.memory import count_memory, rounded
from repro_torch.launch.mesh import dry_mesh
from repro_torch.models import build_model
from repro_torch.models.transformer import block_pattern
from repro_torch.optim import get_client_optimizer, get_server_optimizer
from repro_torch.pytree import flat_dict

AXES = ("pod", "data", "model")
F32 = 4
KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes")


# ---------------------------------------------------------------------------
# the counter on a hand-reckoned step
# ---------------------------------------------------------------------------

def chain_step(device):
    """x [8, 64] @ w1 [64, 32], relu, @ w2 [32, 16], summed; the backward;
    then w1 -= 0.1 * w1.grad in place.  Returns (analysis, backward
    peak)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, generator=g).to(device)
    w1 = torch.randn(64, 32, generator=g).to(device).requires_grad_()
    w2 = torch.randn(32, 16, generator=g).to(device).requires_grad_()
    with count_memory(device) as mem:
        loss = (torch.relu(x @ w1) @ w2).sum()
        with mem.window() as backward:
            loss.backward()
        with torch.no_grad():
            w1.sub_(0.1 * w1.grad)
    return mem.analysis((x, w1, w2), (loss, w1, w2.grad)), backward.peak


def test_hand_reckoned_step():
    """Sizes: x 2048, w1 8192, w2 2048 bytes (arguments); the loss 4
    bytes, charged 512.  The backward's peak comes as w1's gradient is
    made: the loss (512), the root's ones (512, held to the backward's
    end), w2's gradient (2048), the relu's input gradient (8 x 32 f32,
    1024) and w1's gradient (8192).  The step's peak is the update's: the
    loss, both gradients and 0.1 * w1.grad (8192).  Its outputs are the
    loss, w1 (an argument, updated in place: the alias) and w2's gradient,
    which the step allocated (512 + 2048 charged)."""
    for device in ("meta", "cpu"):
        got, backward = chain_step(device)
        assert backward == 512 + 512 + 2048 + 1024 + 8192, device
        peak = 512 + 2048 + 8192 + 8192
        assert got == {"argument_size_in_bytes": 2048 + 8192 + 2048,
                       "output_size_in_bytes": 4 + 8192 + 2048,
                       "temp_size_in_bytes": peak - (512 + 2048),
                       "alias_size_in_bytes": 8192,
                       "peak_size_in_bytes": peak}, device


def test_rounding():
    assert [rounded(n) for n in (0, 1, 512, 513, 1024, 1025)] == \
        [0, 512, 512, 1024, 1024, 1536]


def test_views_and_vmap_of_grad():
    """A view shares its storage (charged once); ``vmap`` of ``grad`` over
    5 clients: the mode sees the batched tensors, and the count is the
    same on ``meta`` and the CPU."""
    for device in ("meta", "cpu"):
        x = torch.zeros(100, device=device)
        with count_memory(device) as mem:
            y = x * 2                             # 400 -> 512
            z = y[10:20].view(2, 5)               # a view: nothing
        assert mem.live == 512 and mem.charged(z) == 512
    counts = []
    for device in ("meta", "cpu"):
        w = torch.zeros(5, 64, 32, device=device)
        x = torch.zeros(5, 8, 64, device=device)
        with count_memory(device) as mem:
            g = torch.func.vmap(torch.func.grad(
                lambda w, x: (x @ w).tanh().sum()))(w, x)
        got = mem.analysis((w, x), g)
        assert got["output_size_in_bytes"] == 5 * 64 * 32 * F32
        assert got["peak_size_in_bytes"] >= rounded(5 * 64 * 32 * F32) \
            + rounded(5 * 8 * 32 * F32)
        counts.append(got)
    assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# argument and output bytes against the reference's memory_analysis
# ---------------------------------------------------------------------------

def reference_analysis(arch, kind, S, B):
    cfg = jreduced(jget_config(arch))
    model = jbuild(cfg)
    params = model.param_specs()
    shape = InputShape("tiny", S, B, kind)
    if kind == "prefill":
        batch, _ = jspecs.prefill_batch_specs(cfg, shape)
        fn, args = (lambda p, b: model.prefill(p, b, s_max=S)), (params,
                                                                 batch)
        out = jax.eval_shape(fn, *args)
    else:
        tok, _, state, _, _, _ = jspecs.decode_inputs_specs(cfg, shape,
                                                             model)
        pos = jax.ShapeDtypeStruct((), jnp.int32)
        fn = lambda p, s, t, i: model.decode_step(p, s, t, i)  # noqa: E731
        args = (params, state, tok, pos)
        out = jax.eval_shape(fn, *args)
    ma = jax.jit(fn).lower(*args).compile().memory_analysis()
    return ma, len(jax.tree.leaves(out))


@pytest.mark.parametrize("arch", ["granite-3-2b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_argument_and_output_bytes_match_reference(arch, kind):
    S, B = 16, 4
    ref, n_out = reference_analysis(arch, kind, S, B)
    ours = dryrun.count_memory(reduced(get_config(arch)),
                               InputShape("tiny", S, B, kind),
                               dry_mesh((1, 1, 1), AXES, 0))
    position = 4 if kind == "decode" else 0      # int32 pos, XLA's only
    assert ours["argument_size_in_bytes"] + position \
        == ref.argument_size_in_bytes
    assert ours["output_size_in_bytes"] + 8 * n_out \
        == ref.output_size_in_bytes
    assert ref.alias_size_in_bytes == 0
    if kind == "decode":                   # the state, updated in place
        assert 0 < ours["alias_size_in_bytes"] \
            < ours["output_size_in_bytes"]
    else:
        assert ours["alias_size_in_bytes"] == 0
    assert ours["temp_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# the kernel wrappers' charges
# ---------------------------------------------------------------------------

K, R, BLK, N = 3, 5, 32, 40
SCAN = (2, 6, 3, 4)                         # B, L, D, N


def wrapper_cases(device):
    """Each wrapper's operands (made before any count) and its call, with
    what its CUDA branch allocates: (outputs' bytes, scratch bytes), each
    entry one allocation."""
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.rand(shape, generator=g).to(device)
    xb, rows, w, s = rnd(K, R, BLK), rnd(R, BLK), rnd(K), rnd(K)
    seeds = torch.randint(0, 2 ** 32, (K, K), generator=g).to(device)
    coef = torch.randint(-1, 2, (K, K), generator=g,
                         dtype=torch.int32).to(device)
    table = torch.arange(R, dtype=torch.int64).to(device)
    noise = rnd(K, R, BLK)
    fw, fg, f0 = rnd(K, N), rnd(K, N), rnd(N)
    B_, L, D, Ns = SCAN
    a, b, h0 = rnd(*SCAN), rnd(*SCAN), rnd(B_, D, Ns)
    hs, g_hs, g_hl = rnd(*SCAN), rnd(*SCAN), rnd(B_, D, Ns)
    rows_out = [R * BLK * F32]
    scan = B_ * L * D * Ns * F32
    lanes = B_ * D * Ns * F32
    return {
        "quantize": (lambda: quantize_dequant_blocks(rows, 8), rows_out, []),
        "topk_sparsify": (lambda: topk_sparsify_blocks(rows, 3), rows_out,
                          []),
        "fused_accum": (lambda: fused_accum_blocks(xb, w, s, 0.5), rows_out,
                        []),
        "plain_commit": (lambda: plain_commit_blocks(xb, w, s, 0.5, bits=8,
                                                     k=3), rows_out, []),
        # scratch: the row table as int32, the folded mask words (1 + 2K^2
        # int32) and the per-row slot thresholds [R, K] int32; the seeds
        # (int64) and coefficients (int32) are taken as they are
        "secure_commit": (lambda: secure_commit_blocks(
            xb, w, seeds, coef, 7, bits=8, k=3, noise=noise, rows=table),
            rows_out, [R * 4, (1 + 2 * K * K) * 4, R * K * 4]),
        "fedprox_update": (lambda: fedprox_update_flat(fw, fg, f0, 0.1,
                                                       0.01),
                           [K * N * F32], []),
        "selective_scan": (lambda: selective_scan_chunk_blocks(a, b, h0),
                           [scan, lanes], []),
        "selective_scan_bwd": (lambda: selective_scan_chunk_bwd_blocks(
            a, hs, h0, g_hs, g_hl), [scan, scan, lanes], []),
    }


@pytest.mark.parametrize("name", list(wrapper_cases("meta")))
def test_wrappers_charge_their_cuda_allocations(name):
    for device in ("meta", "cpu"):
        call, outs, scratch = wrapper_cases(device)[name]
        before = dict(launches.KERNEL_LAUNCHES)
        with count_memory(device) as mem:
            got = call()
        kept = sum(rounded(n) for n in outs)
        assert mem.peak == kept + sum(rounded(n) for n in scratch), device
        assert mem.live == kept, device
        got = got if isinstance(got, tuple) else (got,)
        assert [t.numel() * t.element_size() for t in got] == outs
        assert dict(launches.KERNEL_LAUNCHES) == before


def test_cpu_wrappers_keep_their_plain_results():
    """Under a count, the CPU's result is the plain version's, copied into
    the CUDA branch's allocations."""
    for name, (call, _, _) in wrapper_cases("cpu").items():
        want = call()
        with count_memory("cpu"):
            got = call()
        for x, y in zip(*(t if isinstance(t, tuple) else (t,)
                          for t in (want, got))):
            assert torch.equal(x, y), name


# ---------------------------------------------------------------------------
# the depth check
# ---------------------------------------------------------------------------

FAMILIES = ("granite-3-2b", "qwen3-moe-235b-a22b", "jamba-1.5-large-398b",
            "xlstm-125m", "llama-3.2-vision-90b", "musicgen-medium")


def direct(cfg, shape, mesh, plan):
    """The step's memory analysis counted at ``cfg``'s depth as it is."""
    if shape.kind == "train":
        mem = dryrun._train_pass(cfg, shape, mesh, plan, memory=True)[1]
        mem.pop("train")
        return mem
    return dryrun._serve_pass(cfg, shape, mesh, memory=True)[1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_depth_check(arch):
    """At four layer groups the dry run's count (scaled from one and two
    groups where three lie on their line, else counted whole) equals the
    step's count at that depth, for a parallel round of one sequence a
    client on pod 1 x data 2 x model 2, a prefill and a decode step; the
    xLSTM's prefill at four mLSTM chunks, so that the chunks are checked
    and scaled too (the rest at 8 tokens: the sLSTM steps one token at a
    time)."""
    base = reduced(get_config(arch))
    cfg = base.replace(n_layers=4 * len(block_pattern(base)))
    mesh = dry_mesh((1, 2, 2), AXES, 0)
    plan = dict(clients=2, local_steps=1, client_exec="parallel",
                hierarchical=False)
    for kind in ("train", "prefill", "decode"):
        S = 4 * base.xlstm.chunk if base.xlstm is not None \
            and kind == "prefill" else 8
        shape = InputShape("tiny", S, 2, kind)
        p = plan if kind == "train" else None
        got = dryrun.count_memory(cfg, shape, mesh, p)
        assert got == direct(cfg, shape, mesh, p), kind


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
def test_untrained_clients_allocate_what_training_returns(mode):
    """The commit is counted on untrained deltas and losses
    (``dryrun._untrained``): each call makes them afresh, charged to the
    count as the training's own would be, so the commit's live bytes (the
    last client's loss beside the sequential commit's normalisation)
    are the round's."""
    cfg = reduced(get_config("granite-3-2b"))
    model = build_model(cfg)
    plan = dict(clients=2, local_steps=1, client_exec=mode,
                hierarchical=False)
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"),
                               dryrun.fl_config(plan))
    dryrun._untrained(step)
    params = flat_dict(model.param_specs())
    train = step.train_clients if mode == "parallel" else step.local_train
    with count_memory("meta") as mem:
        outs = [train(params, {}) if mode == "sequential" else train(
            params, {"tokens": torch.empty((2, 1, 1, 4), device="meta")})
            for _ in range(2)]
    losses = [loss for _, loss in outs]
    assert losses[0] is not losses[1]
    assert all(mem.charged(x) == 512 for x in losses)
    assert all(mem.charged(d) > 0 for delta, _ in outs
               for d in delta.values())


def test_linear_scaling_rule():
    """``_linear`` scales from 1 and 2 where 3 lies on their line, else
    from 2 and 3 where 4 lies on theirs, and counts at the whole depth
    where neither does."""
    calls = []

    def at(values):
        def f(n):
            calls.append(n)
            return {"x": values(n), "y": 7}
        return f
    assert dryrun._linear(at(lambda n: 3 + 5 * n), 7) == {"x": 38, "y": 7}
    assert calls == [1, 2, 3]
    calls.clear()
    assert dryrun._linear(at(lambda n: 4 * n if n > 1 else 5), 7) \
        == {"x": 28, "y": 7}
    assert calls == [1, 2, 3, 2, 3, 4]
    calls.clear()
    assert dryrun._linear(at(lambda n: n * n), 7) == {"x": 49, "y": 7}
    assert calls == [1, 2, 3, 2, 3, 4, 7]
    calls.clear()
    assert dryrun._linear(at(lambda n: n * n), 4) == {"x": 16, "y": 7}
    assert calls == [1, 2, 3, 4]


# ---------------------------------------------------------------------------
# the tag's JSON and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module (its import sets XLA_FLAGS for a
    process whose JAX is not yet initialised; the flag is put back)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_tag_json_memory_analysis(tmp_path, capsys):
    dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--mesh",
                 "single", "--groups", "1", "--out", str(tmp_path)])
    data = json.loads((tmp_path / "gemma-2b__decode_32k__single__G1.json")
                      .read_text())
    ma = data["memory_analysis"]
    assert all(isinstance(ma[k], int) for k in KEYS)
    assert ma["argument_size_in_bytes"] == sum(
        data["bytes_per_device"].values())
    assert ma["alias_size_in_bytes"] == data["bytes_per_device"][
        "decode_state"]
    assert ma["temp_size_in_bytes"] > 0
    assert "generated_code_size_in_bytes" not in ma
    assert "generated_code_size_in_bytes" in ma["note"]
    assert f"temp {ma['temp_size_in_bytes'] / 1e9:.2f} GB" \
        in capsys.readouterr().out


def test_reference_key_names(jdryrun):
    """The keys are the ones the reference writes from its compiled
    step's ``memory_analysis`` (its source names them)."""
    import inspect
    src = inspect.getsource(jdryrun.run_one)
    assert all(f'"{k}"' in src for k in KEYS)


def test_cli_goes_on_past_a_failing_tag(tmp_path, monkeypatch):
    def run_one(arch, shape, multi_pod, out_dir, **kw):
        if shape == "prefill_32k":
            raise RuntimeError("boom")
        return {"tag": f"{arch}__{shape}"}
    monkeypatch.setattr(dryrun, "run_one", run_one)
    out = dryrun.main(["--arch", "gemma-2b", "--shape", "all", "--out",
                       str(tmp_path)])
    assert [r["tag"] for r in out] == [
        "gemma-2b__train_4k", "gemma-2b__prefill_32k__single",
        "gemma-2b__decode_32k", "gemma-2b__long_500k"]
    data = json.loads((tmp_path / "gemma-2b__prefill_32k__single.json")
                      .read_text())
    assert data == {"arch": "gemma-2b", "shape": "prefill_32k",
                    "mesh": "single", "tag": "gemma-2b__prefill_32k__single",
                    "error": "RuntimeError: boom"}
