"""The port's flash-attention wrapper against the reference's Pallas kernel.

On the CPU the wrapper computes its plain version; it is held against
``repro.kernels.flash_attention`` run with interpret=True, over the shapes
and dtypes of tests/test_kernels.py at that test's tolerances.  The Hopper
kernel itself runs only on a card: tests/test_torch_kernels_cuda.py holds
it against the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops

SHAPES = [(2, 64, 4, 2, 16, 16, True, 32),
          (1, 128, 8, 8, 32, 32, False, 64),
          (2, 64, 4, 1, 16, 8, True, 16),
          (1, 96, 6, 3, 8, 8, True, 32)]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _inputs(b, s, h, kv, dh, dv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, dh), dtype=np.float32),
            rng.standard_normal((b, s, kv, dh), dtype=np.float32),
            rng.standard_normal((b, s, kv, dv), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,dh,dv,causal,blk", SHAPES)
def test_cpu_wrapper_matches_pallas_kernel(b, s, h, kv, dh, dv, causal, blk, dtype):
    arrays = _inputs(b, s, h, kv, dh, dv)
    ref = ref_flash_attention(*(jnp.asarray(a, dtype) for a in arrays),
                              causal=causal, blk_q=blk, blk_k=blk, interpret=True)
    before = ops.LAUNCHES
    out = ops.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                for a in arrays), causal=causal)
    assert ops.LAUNCHES == before          # the CPU never reaches the kernel
    assert out.dtype == getattr(torch, dtype) and out.shape == (b, s, h, dv)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shapes,match", [
    (((2, 8, 4, 16), (2, 8, 3, 16), (2, 8, 3, 16)), "multiple of kv heads"),
    (((2, 8, 4, 16), (2, 8, 2, 8), (2, 8, 2, 16)), "do not match"),
    (((2, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)), "do not match"),
    (((2, 8, 4), (2, 8, 2, 16), (2, 8, 2, 16)), "takes q"),
])
def test_wrapper_rejects_bad_shapes(shapes, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v)


def test_build_names_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")  # no earlier build
    assert [p.name for p in _build.sources()] == ["flash_attention.cu"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
