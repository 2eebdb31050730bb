"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's
``launch/dryrun.py``, with nothing allocated:

* ``should_skip`` for every assigned arch x input shape equals the
  reference's;
* the per-device bytes of the params and inputs (and a decode shape's
  state) equal the reference's ``ShapeDtypeStruct`` bytes divided by the
  mesh extents of the reference's sanitised specs, on both production
  meshes;
* the flops of a reduced dense prefill equal ``2 x matmul params x
  tokens``, plus the last position's unembedding and the attention's two
  products (``FlopCounterMode`` counts matrix products only); the xLSTM
  family's count scaled from one and two mLSTM chunks equals its count at
  the whole sequence;
* a tag's JSON carries the reference's keys where they have a
  counterpart: ``collective_bytes`` a dict of bytes under the reference's
  kinds, and ``collective_ops_static`` says why it is absent."""
import importlib
import json
import math
import os
from types import SimpleNamespace

import jax
import pytest

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild
from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module.  Importing it sets XLA_FLAGS to 512
    host devices for a process whose JAX is not yet initialised; the flag
    is put back so no later test of this process sees it."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


def test_should_skip_matches_reference(jdryrun):
    for arch in ASSIGNED_ARCHS:
        for name, shape in INPUT_SHAPES.items():
            assert dryrun.should_skip(get_config(arch), shape) \
                == jdryrun.should_skip(jget_config(arch), shape), (arch, name)
    assert dryrun.PARALLEL_ARCHS == jdryrun.PARALLEL_ARCHS
    assert dryrun.COLLECTIVE_OPS == jdryrun.COLLECTIVE_OPS


def ref_bytes(shape_tree, logical_tree, mesh) -> int:
    """The reference's leaves' bytes over the extents of its specs."""
    stand_in = SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)
    leaves = jax.tree.leaves(shape_tree)
    logical = jax.tree.leaves(logical_tree,
                              is_leaf=lambda x: isinstance(x, tuple))
    assert len(leaves) == len(logical)
    total = 0
    for sds, log in zip(leaves, logical):
        spec = jspecs.sanitize_entry(sds.shape, log, stand_in)
        extent = math.prod(mesh.shape[a] for e in spec if e is not None
                           for a in ((e,) if isinstance(e, str) else e))
        total += math.prod(sds.shape) * sds.dtype.itemsize // extent
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_per_device_bytes_match_reference(arch, multi_pod):
    jm, tm = jbuild(jget_config(arch)), build_model(get_config(arch))
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert dryrun.per_device_bytes(tm.param_specs(), tm.logical_specs,
                                   mesh) \
        == ref_bytes(jm.param_specs(), jm.logical_specs, mesh)
    for name, shape in INPUT_SHAPES.items():
        plan = dryrun.train_plan(tm.cfg, multi_pod, 0, 1)
        inputs, logical, state, state_log = dryrun._inputs(tm.cfg, shape, tm,
                                                           plan)
        if shape.kind == "train":
            b, lp, ls = jspecs.train_client_batch_specs(
                jm.cfg, shape, plan["clients"], 1)
            jlog = lp if plan["client_exec"] == "parallel" else ls
            if plan["client_exec"] == "pod_sequential":
                jlog = {k: ("pod", None, "data") + v[3:]
                        for k, v in jlog.items()}
            want = ref_bytes(b, jlog, mesh)
        elif shape.kind == "prefill":
            want = ref_bytes(*jspecs.prefill_batch_specs(jm.cfg, shape),
                             mesh)
        else:
            tok, tlog, st, slog, pt, plog = jspecs.decode_inputs_specs(
                jm.cfg, shape, jm)
            want = ref_bytes({"token": tok, **({"patches": pt} if pt is not
                                               None else {})},
                             {"token": tlog, **({"patches": plog} if pt is
                                                not None else {})}, mesh)
            assert dryrun.per_device_bytes(state, state_log, mesh) \
                == ref_bytes(st, slog, mesh), name
        assert dryrun.per_device_bytes(inputs, logical, mesh) == want, name


def test_dense_prefill_flops():
    cfg = reduced(get_config("granite-3-2b"))
    shape = InputShape("tiny_prefill", 64, 2, "prefill")
    tm = build_model(cfg)
    leaves = [t for slot in tm.param_specs()["layers"].values()
              for name, t in slot.items() if name[0] == "w"]
    matmul_params = sum(t.numel() for t in leaves)
    tokens = shape.global_batch * shape.seq_len
    attention = 2 * 2 * shape.global_batch * shape.seq_len ** 2 \
        * cfg.n_heads * cfg.hd * cfg.n_layers
    unembed = 2 * shape.global_batch * cfg.d_model * cfg.vocab_padded
    assert dryrun.step_flops(cfg, shape) \
        == 2 * matmul_params * tokens + attention + unembed


def test_tag_json(tmp_path, jdryrun):
    out = dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k",
                       "--mesh", "both", "--groups", "1", "--out",
                       str(tmp_path)])
    assert [r["mesh"] for r in out] == ["single", "multi"]
    data = json.loads((tmp_path / "gemma-2b__decode_32k__multi__G1.json")
                      .read_text())
    assert data["n_devices"] == 512 and data["groups_override"] == 1
    assert set(data["bytes_per_device"]) == {"params", "inputs",
                                             "decode_state"}
    assert data["cost_analysis"]["flops"] > 0
    counts = data["collective_bytes"]
    assert counts and all(isinstance(v, int) and v > 0
                          for v in counts.values())
    assert {k.removesuffix("/cross_pod") for k in counts} \
        <= set(jdryrun.COLLECTIVE_OPS)
    assert "not counted" in data["collective_ops_static"]
    skipped = dryrun.run_one("gemma-2b", "long_500k", False, tmp_path,
                             verbose=False)
    assert "skipped" in skipped and "n_devices" not in skipped


def test_xlstm_flops_scale_with_the_sequence():
    """The xLSTM family is counted at one and two mLSTM chunks and scaled
    to the sequence: equal to the count at the sequence itself."""
    cfg = reduced(get_config("xlstm-125m"))
    for kind in ("prefill", "train"):
        shape = InputShape("tiny", 3 * cfg.xlstm.chunk, 4, kind)
        plan = (2, 1) if kind == "train" else (0, 0)
        assert dryrun.step_flops(cfg, shape, *plan) \
            == dryrun.depth_flops(cfg, shape, *plan)
