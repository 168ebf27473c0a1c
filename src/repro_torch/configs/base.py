"""Config dataclasses for the model zoo.

Twin of ``repro.configs.base``: the same fields and counts, with the two
dtype fields holding torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    norm_topk: bool = True
    first_dense: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536        # 0 => full-rank queries
    dh_nope: int = 128
    dh_rope: int = 64
    dh_v: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_inner: int
    headdim: int = 64
    n_state: int = 128
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    window: int = 1024
    n_meta: int = 128


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    n_frames: int = 1500
    max_dec_len: int = 32768


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | mla_moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    mlp: str = "swiglu"              # swiglu | relu2 | gelu
    rope_theta: float = 500000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    aux_loss_weight: float = 0.01
    attn_kv_chunk: int = 512
    attn_q_chunk: int = 512
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    sub_quadratic: bool = False      # can run long_500k decode
    vocab_pad_to: int = 256          # embedding table padded for TP sharding
    source: str = ""                 # provenance note [paper; tier]

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab + p - 1) // p * p

    # ----------------------------------------------------------------- #
    def param_count(self) -> int:
        """Analytic parameter count (embedding tied)."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d                         # embed (tied unembed)
        fam = self.family

        def attn_params():
            return d * (self.n_heads + 2 * self.n_kv) * self.head_dim \
                + self.n_heads * self.head_dim * d

        def mla_params():
            a = self.mla
            q = (d * a.q_lora + a.q_lora * self.n_heads * (a.dh_nope + a.dh_rope)
                 if a.q_lora else d * self.n_heads * (a.dh_nope + a.dh_rope))
            kv = d * (a.kv_lora + a.dh_rope) \
                + a.kv_lora * self.n_heads * (a.dh_nope + a.dh_v)
            o = self.n_heads * a.dh_v * d
            return q + kv + o

        def mlp_params(ff):
            mult = 3 if self.mlp == "swiglu" else 2
            return mult * d * ff

        def moe_params():
            m = self.moe
            routed = m.n_routed * 3 * d * m.d_expert + d * m.n_routed
            shared = mlp_params(m.d_expert * m.n_shared) if m.n_shared else 0
            return routed + shared

        def ssm_params():
            s = self.ssm
            di = s.d_inner
            h = di // s.headdim
            proj = d * (2 * di + 2 * s.n_state + h)
            return proj + di * d + s.conv_width * (di + 2 * s.n_state)

        if fam in ("dense", "vlm"):
            n += L * (attn_params() + mlp_params(self.d_ff))
        elif fam == "moe":
            n += attn_params() * L + mlp_params(self.dense_ff()) \
                + (L - 1) * moe_params()
        elif fam == "mla_moe":
            n += mla_params() * L + mlp_params(self.dense_ff()) \
                + (L - 1) * moe_params()
        elif fam == "ssm":
            n += L * ssm_params()
        elif fam == "hybrid":
            n += L * (attn_params() + ssm_params() + mlp_params(self.d_ff))
            n += self.hybrid.n_meta * d
        elif fam == "encdec":
            e = self.encdec
            n += e.n_enc_layers * (attn_params() + mlp_params(self.d_ff))
            n += L * (2 * attn_params() + mlp_params(self.d_ff))
            n += e.max_dec_len * d                 # learned decoder positions
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if self.family not in ("moe", "mla_moe"):
            return self.param_count()
        m = self.moe
        d, L = self.d_model, self.n_layers
        full = self.param_count()
        routed_all = (L - 1) * m.n_routed * 3 * d * m.d_expert
        routed_active = (L - 1) * m.top_k * 3 * d * m.d_expert
        return full - routed_all + routed_active

    def dense_ff(self) -> int:
        """FFN width of the dense first layer in MoE archs."""
        m = self.moe
        return m.d_expert * (m.n_shared + m.top_k)
