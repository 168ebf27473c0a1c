"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere.  The file imports no JAX, so on a machine without it the tests
run with ``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_kernels_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import naive_attention, ops

SHAPES = [(2, 64, 4, 2, 16, 16, True), (1, 128, 8, 8, 32, 32, False),
          (2, 64, 4, 1, 16, 8, True), (1, 96, 6, 3, 8, 8, True),
          (1, 100, 4, 2, 128, 64, True), (2, 70, 4, 4, 64, 128, False),
          (4, 1024, 32, 8, 128, 128, True)]
# fp32: the card sums in another order than the plain version;
# bf16: the reference's own bound (tests/test_kernels.py:38)
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
FP32_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, s, h, kv, dh, dv, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 .to(device, dtype)
                 for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dv)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,dh,dv,causal", SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, b, s, h, kv, dh, dv,
                                              causal, dtype):
    q, k, v = _inputs(b, s, h, kv, dh, dv, dtype, cuda_device)
    before = ops.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == (b, s, h, dv)
    err = (out.float() - naive_attention(q, k, v, causal=causal).float()).abs().max()
    assert float(err) <= TOL[dtype], float(err)
    # the bf16 plain version rounds scores and P to bf16, the kernel does not:
    # against the plain version in fp32 it is within about one output ulp
    exact = naive_attention(q.float(), k.float(), v.float(), causal=causal)
    torch.testing.assert_close(out.float(), exact, atol=FP32_TOL[dtype],
                               rtol=FP32_TOL[dtype])


def test_flash_attention_kernel_refuses_what_it_cannot_take(cuda_device):
    q, k, v = _inputs(1, 16, 2, 1, 16, 16, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    big = _inputs(1, 16, 2, 1, 160, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(*big)
    with pytest.raises(ValueError, match="different devices"):
        ops.flash_attention(q, k.cpu(), v)
