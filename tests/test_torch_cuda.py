"""The port's CUDA kernels against their plain versions on the card.

Marked `cuda`: each test skips where torch sees no CUDA device. On a GPU
machine with nvcc: python -m pytest tests/test_torch_cuda.py -m cuda -q
Tolerance 1e-4: the kernel sums in another order over K and L layers.
"""

import pytest
import torch

from multilingual_multimodal_speech_emotion_recognition_tpu_torch.models import (
    layers as tl, classifier as tclf)
from multilingual_multimodal_speech_emotion_recognition_tpu_torch.ops import (
    residual_stack as rs)

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _perturbed_stack(device, L, D, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    stacked = tclf.init_classifier(tl.Init(g, device), 8, 4, L, D)["layers"]
    for sub in stacked.values():
        for k, v in sub.items():
            if k != "kernel":
                v += 0.1 * torch.randn(v.shape, device=device, generator=g)
    return stacked, torch.randn(11, D, device=device, generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("L,D", [(35, 512), (3, 32), (2, 768)])
def test_residual_stack_kernel_matches_plain(cuda, L, D):
    stacked, x = _perturbed_stack(cuda, L, D, seed=D)
    before = rs.residual_stack.launches
    for B in (1, 4, 11):
        got = rs.residual_stack(stacked, x[:B].contiguous())
        want = rs.residual_stack_plain(stacked, x[:B])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert rs.residual_stack.launches == before + 3


@pytest.mark.cuda
def test_residual_stack_kernel_rejects_what_it_does_not_take(cuda):
    stacked, x = _perturbed_stack(cuda, 2, 32, seed=0)
    with pytest.raises(ValueError, match="f32"):
        rs.residual_stack(stacked, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        rs.residual_stack(stacked, x.t().contiguous().t())
