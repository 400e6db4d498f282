"""Loss and gradients of the port's ``bundle.loss_fn`` against
``jax.value_and_grad`` of the reference's for the hybrid (zamba2-1.2b),
audio (whisper-large-v3) and vlm (llama-3.2-vision-90b, both gates 0.5)
families, at fp32 and at the defaults, with the bars and fixtures of
tests/test_torch_train_loss.py."""

import pytest
import torch

from test_torch_train_loss import check

torch.set_num_threads(1)


@pytest.mark.parametrize("precision", ["f32", "default"])
@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_loss_and_grads_match_reference(arch, precision):
    check(arch, precision)
