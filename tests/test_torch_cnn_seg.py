"""The port's Mini-Seg (its nearest resize, from 7 to 13 at the odd res) and its calibration against
the JAX package's, at width 8 and res 12 and 13: the checks and tolerances
of ``tests/test_torch_cnn.py``.
"""
import pytest
import torch

from tests.test_torch_cnn import MODES, RESES, build_nets, check_apply, check_calibrate

torch.set_num_threads(1)

ARCH = "mini_seg"


@pytest.fixture(scope="module")
def nets():
    return build_nets(ARCH, 2)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("res", RESES)
def test_calibrate_matches_jax(nets, res, per_channel):
    check_calibrate(nets[res], per_channel)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("res", RESES)
def test_cnn_apply_matches_jax(nets, res, per_channel, mode):
    check_apply(nets[res], per_channel, mode)
