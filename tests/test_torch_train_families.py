"""The port's ``train_loss`` and every grad leaf against
``jax.value_and_grad`` of the reference's, for the other half of the
registered configs (``tests/test_torch_train_model.py`` holds the first):
the MoE with a dense residual, the SSD families, the encoder-decoder and
the vision decoder (tolerances in ``tests/_torch_train_common.py``)."""
import pytest

from _torch_train_common import check_loss_and_grads


@pytest.mark.parametrize("arch", ["arctic-480b", "mamba2-2.7b", "zamba2-7b",
                                  "seamless-m4t-medium", "phi-3-vision-4.2b"])
def test_train_loss_and_grads_match_jax(arch):
    check_loss_and_grads(arch)
