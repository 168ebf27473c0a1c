"""Port configs vs the reference: every field of the four dense archs, full
and smoke, with the dtype fields mapped to torch dtypes."""
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro_torch.configs import ARCH_IDS, get_config

DENSE = ("llama3-8b", "nemotron-4-15b", "chatglm3-6b", "qwen3-32b")
NOT_PORTED = ("whisper-medium", "deepseek-moe-16b", "deepseek-v2-236b",
              "mamba2-130m", "hymba-1.5b", "pixtral-12b")


def _torch_dtype(jax_dtype):
    return getattr(torch, jnp.dtype(jax_dtype).name)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference(arch, smoke):
    ref, port = ref_get_config(arch, smoke), get_config(arch, smoke)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        if f.name in ("param_dtype", "compute_dtype"):
            want = _torch_dtype(want)
        assert getattr(port, f.name) == want, f.name
    assert port.padded_vocab == ref.padded_vocab
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


def test_registry_ports_dense_archs_and_refuses_the_rest():
    assert ARCH_IDS == DENSE
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
