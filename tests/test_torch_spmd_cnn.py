"""CNN rounds across real processes: four ``gloo`` ranks on the CPU
(``repro_torch.launch.spmd``) on a ``pod`` 2 x ``data`` 2 x ``model`` 1
mesh run the port's round step, each on its share of the clients, pods
or batch, and the results come back here.

  * parallel with ``client_spmd_axes=("pod", "data")``: two clients a
    rank, no batch split; uncompressed, deterministic q8 + top-k and
    secure q8 + top-k with stochastic rounding, and under
    ``client_spmd_axes=("data",)`` (each client's batch split over pod);
  * pod_sequential, ``n_pods=2`` over ``("pod",)``, each client's batch
    split over ``data``;
  * sequential, each client's batch split over ``data``.

Against the port's round with no mesh in this process: bit for bit where
no batch is split (the parallel rounds, and the commit of the no-mesh
deltas under the mesh), within 1e-5 of the params' scale where a batch is
(the gradients' mean over the ranks sums in another order).  Against the
JAX reference's unsharded round, uncompressed: within 1e-5.  And the
params end bit for bit the same on every rank
(``sharding.replica_checksums``), also where the pods of a sequential
round, which repeat the same work, compute gradients that differ in their
last bits (as a card's non-deterministic algorithms can make them): the
round's gradient mean runs over the pods as well."""
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import CompressionConfig, FLConfig, build_fl_round_step
from repro_torch.launch import spmd
from repro_torch.models import sharding as sh
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.optim import get_client_optimizer, get_server_optimizer

NARROW = dict(name="t", in_shape=(8, 8, 1), num_classes=3, channels=(4, 8),
              dense=16)
C, H, B, LR = 8, 2, 4, 0.1
TOL = 1e-5
Q8_TOPK = dict(quantize_bits=8, topk_frac=0.1, stochastic_rounding=False)
# (label, client_exec, client_spmd_axes, compression, secure_agg)
CASES = [
    ("parallel", "parallel", ("pod", "data"), {}, False),
    ("parallel q8_topk", "parallel", ("pod", "data"), Q8_TOPK, False),
    ("parallel secure stochastic", "parallel", ("pod", "data"),
     dict(quantize_bits=8, topk_frac=0.1), True),
    ("parallel over data", "parallel", ("data",), {}, False),
    ("pod_sequential", "pod_sequential", ("pod",), {}, False),
    ("sequential", "sequential", None, {}, False),
]
BATCH_SPLIT = {"parallel over data", "pod_sequential", "sequential"}


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    batches = {
        "image": rng.normal(size=(C, H, B) + NARROW["in_shape"]
                            ).astype(np.float32),
        "label": rng.integers(0, NARROW["num_classes"], (C, H, B)
                              ).astype(np.int32)}
    weights = rng.uniform(10, 50, C).astype(np.float32)
    mask = np.ones(C, np.float32)
    mask[5] = 0.0
    return batches, weights, mask


def jax_params():
    import jax
    from repro.models.cnn import CNN as JCNN
    from repro.models.cnn import CNNConfig as JConfig
    jp = JCNN(JConfig(**NARROW)).init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in jp.items()}


def step_of(exec_mode, axes, comp, secure):
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=LR,
                  client_exec=exec_mode, secure_agg=secure,
                  compression=CompressionConfig(**comp))
    return build_fl_round_step(CNN(CNNConfig(**NARROW)).loss_fn,
                               get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl, n_pods=2,
                               client_spmd_axes=axes)


def run_round(case, params, batches, weights, mask):
    _, exec_mode, axes, comp, secure = case
    new, _, met = step_of(exec_mode, axes, comp, secure)(
        params, (), batches, weights, mask, torch.Generator().manual_seed(3))
    return new, {k: float(v) for k, v in met.items()}


def torch_inputs(params_np):
    b, w, m = inputs()
    return (convert.params_from_jax(params_np),
            {k: torch.from_numpy(v) for k, v in b.items()},
            torch.from_numpy(w), torch.from_numpy(m))


def commit_of_whole_deltas(params, batches, weights, mask):
    """The parallel q8 + top-k commit of deltas trained with no mesh (all
    clients in each process), the commit under the mesh on this process's
    share of them."""
    step = step_of("parallel", ("pod", "data"), Q8_TOPK, False)
    with sh.use_mesh(None):
        deltas, losses = step.train_clients(params, batches)
    share = step.client_share
    new, _, _ = step.commit(params, (), {k: share(d) for k, d in
                                         deltas.items()}, share(losses),
                            share(weights), share(mask),
                            torch.Generator().manual_seed(3))
    return new


def pods_disagreeing(mesh, params, batches, weights, mask):
    """The sequential round, each pod's loss (and so its gradients) moved by
    a term of its own that is far below the loss's scale: whether the
    params end the same on every rank, and their largest gap to the round
    without the term."""
    base = CNN(CNNConfig(**NARROW)).loss_fn
    pod = mesh.coords["pod"]

    def loss_fn(p, b):
        loss, aux = base(p, b)
        return loss + 1e-6 * pod * sum(v.sum() for v in p.values()), aux

    fl = FLConfig(num_clients=C, local_steps=H, client_lr=LR,
                  client_exec="sequential")
    step = build_fl_round_step(loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    new, _, _ = step(params, (), batches, weights, mask,
                     torch.Generator().manual_seed(3))
    return new, all(len(set(v)) == 1
                    for v in sh.replica_checksums(new).values())


def rank_rounds(mesh, params_np):
    params, batches, weights, mask = torch_inputs(params_np)
    out = {}
    for case in CASES:
        new, met = run_round(case, params, batches, weights, mask)
        sums = sh.replica_checksums(new)
        out[case[0]] = (new, met, all(len(set(v)) == 1
                                      for v in sums.values()))
    out["commit"] = commit_of_whole_deltas(params, batches, weights, mask)
    out["pods disagreeing"] = pods_disagreeing(mesh, params, batches,
                                               weights, mask)
    return out


@pytest.fixture(scope="module")
def params_np():
    return jax_params()


@pytest.fixture(scope="module")
def ranks(params_np, tmp_path_factory):
    return spmd.run(rank_rounds, (params_np,), sizes=(2, 2, 1), device="cpu",
                    init_method=spmd.init_file(tmp_path_factory.mktemp(
                        "spmd_cnn")), verbose=False)


def max_rel(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max()
                     / (want[k].abs().max() + 1e-12)) for k in want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_round_against_no_mesh(ranks, params_np, case):
    params, batches, weights, mask = torch_inputs(params_np)
    want, want_met = run_round(case, params, batches, weights, mask)
    got, met, replicas_equal = ranks[case[0]]
    assert replicas_equal, "params differ between ranks"
    if case[0] in BATCH_SPLIT:
        assert max_rel(got, want) <= TOL
        for k in ("client_loss", "delta_norm"):
            assert abs(met[k] - want_met[k]) <= TOL * abs(want_met[k]), k
    else:
        for k in want:
            assert torch.equal(got[k], want[k]), k
        assert met == want_met


def test_commit_of_the_same_deltas_bit_for_bit(ranks, params_np):
    params, batches, weights, mask = torch_inputs(params_np)
    with sh.use_mesh(None):
        want = commit_of_whole_deltas(params, batches, weights, mask)
    for k in want:
        assert torch.equal(ranks["commit"][k], want[k]), k


def test_replicas_that_compute_different_bits_end_equal(ranks, params_np):
    """Ranks in different pods repeat a sequential round's work; where they
    compute different bits, the gradients' mean over the pods hands them
    all the same ones, and the round stays near the one without the
    difference."""
    got, replicas_equal = ranks["pods disagreeing"]
    assert replicas_equal, "params differ between ranks"
    want = ranks["sequential"][0]
    assert 0.0 < max_rel(got, want) <= 1e-4


@pytest.mark.parametrize("case", [c for c in CASES if not c[3]],
                         ids=[c[0] for c in CASES if not c[3]])
def test_round_against_jax_reference(ranks, params_np, case):
    """The uncompressed sharded rounds against the reference's unsharded
    round of the same mode."""
    import jax
    import jax.numpy as jnp
    from repro.core import FLConfig as JFL
    from repro.core import build_fl_round_step as j_build
    from repro.models.cnn import CNN as JCNN
    from repro.models.cnn import CNNConfig as JConfig
    from repro.optim import get_client_optimizer as j_copt
    from repro.optim import get_server_optimizer as j_sopt
    jfl = JFL(num_clients=C, local_steps=H, client_lr=LR,
              client_exec=case[1])
    jstep = jax.jit(j_build(JCNN(JConfig(**NARROW)).loss_fn, j_copt("sgd"),
                            j_sopt("fedavg"), jfl, n_pods=2))
    b, w, m = inputs()
    jp, _, jmet = jstep({k: jnp.asarray(v) for k, v in params_np.items()},
                        (), {k: jnp.asarray(v) for k, v in b.items()},
                        jnp.asarray(w), jnp.asarray(m),
                        jax.random.PRNGKey(3))
    got, met, _ = ranks[case[0]]
    want = convert.params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    assert max_rel(got, want) <= TOL
    assert abs(met["client_loss"] - float(jmet["client_loss"])) <= TOL * abs(
        float(jmet["client_loss"]))
