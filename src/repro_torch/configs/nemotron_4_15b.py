"""nemotron-4-15b [dense] — GQA kv=8, squared-ReLU MLP.
[arXiv:2402.16819; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
        d_ff=24576, vocab=256000, mlp="relu2", rope_theta=10000.0,
        source="[arXiv:2402.16819; unverified]",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
        d_ff=192, vocab=256, mlp="relu2", rope_theta=10000.0,
        attn_kv_chunk=16, attn_q_chunk=16,
    )
