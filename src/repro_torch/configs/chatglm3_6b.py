"""chatglm3-6b [dense] — GQA kv=2, 2d (half-dim) RoPE.  [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv=2, head_dim=128,
        d_ff=13696, vocab=65024, mlp="swiglu",
        rope_theta=10000.0, rope_fraction=0.5,
        source="[arXiv:2406.12793; hf]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, mlp="swiglu",
        rope_theta=10000.0, rope_fraction=0.5,
        attn_kv_chunk=16, attn_q_chunk=16,
    )
