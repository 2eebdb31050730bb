"""The logical sharding specs and the dry run's sanitised specs against the
reference, for every assigned arch at full width, built on the ``meta``
device (nothing allocated):

* ``LM.logical_specs`` (every ``ParamBuilder.add`` call's logical tuple)
  and ``LM.state_logical_specs`` equal the reference's, entry for entry;
* ``logical_to_pspec_tree`` and ``launch.specs.sanitize_specs`` (the
  divisibility gate) give the reference's ``PartitionSpec`` for every leaf
  on the 16x16 and 2x16x16 production meshes (the reference's
  ``sanitize_entry`` per leaf on a stand-in with the same names and sizes:
  its ``sanitize_specs`` wraps each in a ``NamedSharding`` of a real mesh);
* the batch, prefill and decode stand-ins have the reference's shapes,
  dtypes and logical tuples."""
from types import SimpleNamespace

import jax
import pytest

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import specs as jspecs
from repro.models import build_model as jbuild
from repro.models import common as jcommon
from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import common
from repro_torch.pytree import ordered


def flat_dict(tree, prefix=""):
    """{"/"-joined path: leaf} over the dict levels only (a logical spec or
    a PartitionSpec is a tuple, and a leaf here), in ``jax.tree`` order."""
    out = {}
    for k in ordered(tree):
        v, path = tree[k], prefix + k
        out.update(flat_dict(v, path + "/") if isinstance(v, dict)
                   else {path: v})
    return out


def stand_in(mesh):
    return SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)


def flat_logical(tree):
    """{path: logical tuple} of a tree whose leaves are tuples."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {"/".join(k.key for k in path): leaf for path, leaf in flat}


def flat_shapes(tree):
    return {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=ASSIGNED_ARCHS)
def models(request):
    arch = request.param
    return jbuild(jget_config(arch)), build_model(get_config(arch))


def test_logical_specs_match_reference(models):
    jm, tm = models
    want = flat_logical(jm.logical_specs)
    got = flat_dict(tm.logical_specs)
    assert list(got) == list(want)
    assert got == want
    assert tm.attn_tp == jm.attn_tp
    for B, S in ((2, 64), (1, 32768)):
        assert flat_dict(tm.state_logical_specs(B, S)) == flat_logical(
            jm.state_logical_specs(B, S))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_sanitized_param_specs_match_reference(models, multi_pod):
    jm, tm = models
    mesh = make_production_mesh(multi_pod=multi_pod)
    ref_mesh = stand_in(mesh)
    shapes = flat_shapes(jm.param_specs())
    logical = flat_logical(jm.logical_specs)
    got = flat_dict(specs.sanitize_specs(tm.param_specs(), tm.logical_specs,
                                         mesh))
    pspecs = flat_dict(common.logical_to_pspec_tree(tm.logical_specs, mesh))
    assert list(got) == list(shapes)
    for k, sds in shapes.items():
        assert got[k] == jspecs.sanitize_entry(sds.shape, logical[k],
                                               ref_mesh), k
        assert pspecs[k] == jcommon.logical_to_pspec_tree(
            {"x": logical[k]}, ref_mesh)["x"], k
    assert flat_dict(common.logical_to_pspec_tree(tm.logical_specs, None)) \
        == {k: () for k in shapes}


def _same_leaves(got: dict, want: dict):
    """Meta tensors against ShapeDtypeStructs: shapes and dtypes."""
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(want[k].dtype), k


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_input_stand_ins_match_reference(models, shape):
    jm, tm = models
    jcfg, cfg = jm.cfg, tm.cfg
    ishape = INPUT_SHAPES[shape]
    mesh = make_production_mesh(multi_pod=True)
    if ishape.kind == "train":
        want = jspecs.train_client_batch_specs(jcfg, ishape, 4, 2)
        got = specs.train_client_batch_specs(cfg, ishape, 4, 2)
        _same_leaves(got[0], want[0])
        assert got[1:] == want[1:]
        for logical in got[1:]:
            for k, t in got[0].items():
                assert specs.sanitize_entry(tuple(t.shape), logical[k],
                                            mesh) == jspecs.sanitize_entry(
                    want[0][k].shape, logical[k], stand_in(mesh))
    elif ishape.kind == "prefill":
        want = jspecs.prefill_batch_specs(jcfg, ishape)
        got = specs.prefill_batch_specs(cfg, ishape)
        _same_leaves(got[0], want[0])
        assert got[1] == want[1]
    else:
        want = jspecs.decode_inputs_specs(jcfg, ishape, jm)
        got = specs.decode_inputs_specs(cfg, ishape, tm)
        _same_leaves({"token": got[0]}, {"token": want[0]})
        assert got[1] == want[1]
        _same_leaves(flat_dict(got[2]), flat_shapes(want[2]))
        assert flat_dict(got[3]) == flat_logical(want[3])
        assert (got[4] is None) == (want[4] is None)
        if got[4] is not None:
            _same_leaves({"p": got[4]}, {"p": want[4]})
            assert got[5] == want[5]
        state_specs = flat_dict(specs.sanitize_specs(got[2], got[3], mesh))
        for k, leaf in flat_shapes(want[2]).items():
            assert state_specs[k] == jspecs.sanitize_entry(
                leaf.shape, flat_logical(want[3])[k], stand_in(mesh)), k
