"""ddti_tpu_torch/core/device.py:resolve_device, which every entry point
of the port resolves its device through (the training CLI at
cli/main.py:_run, the daemon and the other CLIs, api.fit and api.load,
the bundle loader): on CUDA it turns both TF32 flags off, so float32
convolutions and matrix products run in full float32. The card is faked
with a monkeypatched ``torch.cuda.is_available``; the flags are global
and are restored after each test."""

import pytest
import torch

from ddti_tpu_torch.core.device import resolve_device


@pytest.fixture()
def tf32_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("name", ["cuda", "cuda:0", "cuda:3"])
def test_resolve_device_turns_tf32_off_on_cuda(monkeypatch, tf32_flags,
                                               name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    device = resolve_device(name)
    assert device == torch.device(name)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_resolve_device_leaves_tf32_alone_on_the_cpu(tf32_flags):
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True


def test_resolve_device_refuses_a_missing_card(monkeypatch, tf32_flags):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="expected cuda"):
        resolve_device("meta")
