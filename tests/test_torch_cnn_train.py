"""The CNN track's data, training and entry points in the port against the
JAX package's: ``make_gratings``, ``seg_labels`` and every corruption of
``data/corruptions.py`` (numpy copies: bit-equal for the same seed and
``np.random.Generator``), one and two ``train_cnn`` steps of the
reference's hand-written Adam from the reference's weights on the same
batches (params within 1e-5 relative: the forward and backward sums reduce
in another order; atol the larger of 1e-6 of each leaf's largest |value|
and 1e-3 of the learning rate, since Adam's update lr * m / (sqrt(v) + eps)
normalises the gradient, so a rounding of a gradient near 0 moves its
update by a share of lr: one element of 9216 by 8.5e-7 after two steps),
``evaluate`` (accuracies equal), ``cnn_params_from_numpy`` (a round trip
bit for bit) and the device policy (the card unless the caller asks for the
CPU; without CUDA an error).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import spec_for_mode as jspec
from repro.data import corruptions as jcor
from repro.models import cnn as jc
from repro_torch.bridge import cnn_params_from_numpy
from repro_torch.core import spec_for_mode as tspec
from repro_torch.data import corruptions as tcor
from repro_torch.models import cnn as tc
from tests.test_torch_core import equal

torch.set_num_threads(1)


@pytest.mark.parametrize("n_classes,noise,res", [(10, 0.15, 24), (16, 0.45, 20), (6, 0.45, 13)])
def test_gratings_and_seg_labels_bit_equal(n_classes, noise, res):
    for key in (0, 77, 1001):
        ji, jl = jc.make_gratings(key, 9, res=res, n_classes=n_classes, noise=noise)
        ti, tl = tc.make_gratings(key, 9, res=res, n_classes=n_classes, noise=noise)
        equal(ti, ji)
        equal(tl, jl)
        equal(tc.seg_labels(tl, res, n_classes), jc.seg_labels(jl, res, n_classes))


@pytest.mark.parametrize("name", list(jcor.CORRUPTIONS) + ["combination"])
@pytest.mark.parametrize("severity", [1, 3, 5])
def test_corruption_bit_equal(name, severity):
    x, _ = jc.make_gratings(3, 4, res=12, n_classes=6)
    x = x.astype(np.float64)
    fj = jcor.combination if name == "combination" else jcor.CORRUPTIONS[name]
    ft = tcor.combination if name == "combination" else tcor.CORRUPTIONS[name]
    for seed in range(3):
        equal(ft(x, severity, np.random.default_rng(seed)),
              fj(x, severity, np.random.default_rng(seed)))


@pytest.mark.parametrize("max_severity", [1, 3, 5])
def test_corrupt_batch_bit_equal(max_severity):
    x, _ = jc.make_gratings(4, 24, res=12, n_classes=6)
    assert tcor.SEVERITY == jcor.SEVERITY
    equal(tcor.corrupt_batch(x, np.random.default_rng(max_severity), max_severity),
          jcor.corrupt_batch(x, np.random.default_rng(max_severity), max_severity))


def _leaves(tree, prefix=""):
    """A param tree's leaves by path ('ir1/dw')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("arch", ["mini_resnet", "mini_mobilenet", "mini_seg"])
def test_train_cnn_steps_match_jax(arch, steps):
    """``train_cnn`` from the reference's initial weights (its ``cnn_init`` at
    the same seed) against the reference's ``train_cnn``: the same batches
    (seed 1000 + t), the same Adam in the same float order."""
    seg = arch == "mini_seg"
    jcfg = jc.CNNConfig(arch=arch, width=8, res=12, n_classes=6)
    tcfg = tc.CNNConfig(arch=arch, width=8, res=12, n_classes=6)
    j0 = jc.cnn_init(jax.random.PRNGKey(3), jcfg)
    lr = 2e-3
    j1 = jc.train_cnn(jcfg, steps=steps, batch=8, lr=lr, seed=3, segmentation=seg)
    t1 = tc.train_cnn(tcfg, steps=steps, batch=8, lr=lr, segmentation=seg, device="cpu",
                      params=cnn_params_from_numpy(jax.tree.map(np.asarray, j0), "cpu"))
    jl, tl = _leaves(j1), _leaves(t1)
    assert sorted(jl) == sorted(tl)
    moved = 0
    for k in jl:
        a, b = np.asarray(jl[k]), tl[k].numpy()
        assert not tl[k].requires_grad and tl[k].device.type == "cpu"
        atol = max(1e-6 * float(np.abs(a).max()), 1e-3 * lr)
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=atol, err_msg=k)
        moved += not np.array_equal(a, np.asarray(_leaves(j0)[k]))
    assert moved == len(jl)                    # every leaf took the step


def test_evaluate_matches_jax():
    cfg = jc.CNNConfig(arch="mini_resnet", width=8, res=12, n_classes=6)
    jp = jc.cnn_init(jax.random.PRNGKey(0), cfg)
    tp = cnn_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    imgs, labels = jc.make_gratings(77, 40, res=12, n_classes=6)
    for mode in ("none", "dynamic"):
        a = jc.evaluate(jp, cfg, imgs, labels, spec=jspec(mode), batch=16)
        b = tc.evaluate(tp, tc.CNNConfig(**vars(cfg)), imgs, labels, spec=tspec(mode), batch=16)
        assert a == b


def test_cnn_params_round_trip_and_device_policy():
    cfg = jc.CNNConfig(arch="mini_mobilenet", width=8, res=12, n_classes=6)
    tree = jax.tree.map(np.asarray, jc.cnn_init(jax.random.PRNGKey(0), cfg))
    tp = cnn_params_from_numpy(tree, "cpu")
    assert sorted(_leaves(tp)) == sorted(_leaves(tree))
    for k, a in _leaves(tree).items():
        equal(_leaves(tp)[k], a)
    tcfg = tc.CNNConfig(arch="mini_mobilenet", width=8, res=12, n_classes=6)
    own = tc.cnn_init(0, tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(own).items()} == {
        k: a.shape for k, a in _leaves(tree).items()}
    for k, v in _leaves(tc.cnn_init(0, tcfg, device="cpu")).items():
        equal(v, _leaves(own)[k])           # a seed gives the same weights
    calls = (lambda: cnn_params_from_numpy(tree),
             lambda: tc.cnn_init(0, tcfg),
             lambda: tc.train_cnn(tcfg, steps=1, batch=2))
    for call in calls:
        if torch.cuda.is_available():
            assert _leaves(call())["fc"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    with pytest.raises(ValueError):
        tc.cnn_init(0, tc.CNNConfig(arch="mini_vit"), device="cpu")

