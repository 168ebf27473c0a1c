"""qwen3-32b [dense] — GQA kv=8 with per-head qk RMS-norm.
[hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv=8, head_dim=128,
        d_ff=25600, vocab=151936, mlp="swiglu", rope_theta=1000000.0,
        qk_norm=True,
        source="[hf:Qwen/Qwen3-8B; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, mlp="swiglu", rope_theta=1000000.0,
        qk_norm=True, attn_kv_chunk=16, attn_q_chunk=16,
    )
