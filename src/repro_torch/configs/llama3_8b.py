"""llama3-8b [dense] — GQA kv=8, 128k vocab.  [arXiv:2407.21783; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
        d_ff=14336, vocab=128256, mlp="swiglu", rope_theta=500000.0,
        source="[arXiv:2407.21783; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=128, vocab=256, mlp="swiglu", rope_theta=500000.0,
        attn_kv_chunk=16, attn_q_chunk=16,
    )
