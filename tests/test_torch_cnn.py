"""The port's CNN (``repro_torch.models.cnn``) against the JAX package's on
the same params (JAX's init, copied through ``convert.params_from_jax``)
and the same numpy batch: loss, accuracy and grads at a narrow width, and
one forward at the full CIFAR width.  Tolerance 1e-5: float32 sums taken
in another order."""
import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import CIFAR_CNN as J_CIFAR
from repro.models.cnn import CNN as JCNN
from repro.models.cnn import CNNConfig as JConfig
from repro_torch import convert
from repro_torch.models import cnn
from repro_torch.models.cnn import CIFAR_CNN, CNN, MEDMNIST_CNN, CNNConfig

NARROW = dict(name="t", in_shape=(8, 8, 1), num_classes=3, channels=(4, 8),
              dense=16)


def batch(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n,) + cfg.in_shape).astype(np.float32),
            "label": rng.integers(0, cfg.num_classes, n).astype(np.int32)}


def pair(jcfg, tcfg, seed=0):
    jm, tm = JCNN(jcfg), CNN(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, tm, jp, convert.params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()})


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_shapes_and_init_distributions_match():
    tm = CNN(CIFAR_CNN)
    jp = JCNN(J_CIFAR).init(jax.random.PRNGKey(0))
    tp = tm.init(torch.Generator().manual_seed(0))
    assert list(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        if k.endswith("_b"):
            assert not tp[k].any()
        else:   # same scale: conv 0.1, dense 1/sqrt(fan_in)
            np.testing.assert_allclose(tp[k].std().item(),
                                       float(np.std(np.asarray(jp[k]))),
                                       rtol=0.1)


@pytest.mark.parametrize("narrow", [NARROW, dict(NARROW, in_shape=(9, 9, 2))])
def test_loss_acc_grads_match_jax(narrow):
    assert_loss_acc_grads_match_jax(narrow)


@pytest.mark.parametrize("narrow", [NARROW, dict(NARROW, in_shape=(9, 9, 2))])
def test_library_conv_grads_match_jax(narrow, monkeypatch):
    """The card's convolution (``F.conv2d``, cuDNN there) run here in
    place of the CPU's lane-exact im2col: the same loss and grads."""
    monkeypatch.setattr(cnn, "_conv", cnn._conv_library)
    assert_loss_acc_grads_match_jax(narrow)


def assert_loss_acc_grads_match_jax(narrow):
    jm, tm, jp, tp = pair(JConfig(**narrow), CNNConfig(**narrow))
    b = batch(tm.cfg, 6)
    (jl, jaux), jg = jax.value_and_grad(jm.loss_fn, has_aux=True)(jp, b)
    tg, (tl, taux) = torch.func.grad_and_value(tm.loss_fn, has_aux=True)(
        tp, tbatch(b))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert taux["acc"].item() == pytest.approx(float(jaux["acc"]))
    assert tm.accuracy(tp, tbatch(b)).item() == pytest.approx(
        float(jm.accuracy(jp, b)))
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-6)


def test_full_cifar_width_forward_matches_jax():
    jm, tm, jp, tp = pair(J_CIFAR, CIFAR_CNN, seed=1)
    b = batch(CIFAR_CNN, 2, seed=1)
    got = tm.apply(tp, torch.from_numpy(b["image"])).numpy()
    want = np.asarray(jm.apply(jp, b["image"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_medmnist_config_matches_reference():
    from repro.models.cnn import MEDMNIST_CNN as J_MED
    assert (MEDMNIST_CNN.in_shape, MEDMNIST_CNN.num_classes,
            MEDMNIST_CNN.channels, MEDMNIST_CNN.dense) == \
        (J_MED.in_shape, J_MED.num_classes, J_MED.channels, J_MED.dense)
