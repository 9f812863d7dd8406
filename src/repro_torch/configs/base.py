"""Model configuration schema of the port (a copy of
``repro/configs/base.py`` without ``jax``).

Every ``src/repro_torch/configs/<arch>.py`` builds a :class:`ModelConfig`
with the published hyper-parameters (source cited in the file) and a
reduced ``smoke()`` variant for CPU tests. ``torch_dtype`` takes the
place of the JAX package's ``jnp_dtype``.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention
    attention: str = "full"         # full | sliding | none
    window: int = 4096              # sliding-window size
    rope: str = "standard"          # standard | partial | mrope | sinusoidal | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0      # 'partial': fraction of head_dim rotated
    qkv_bias: bool = False

    # norm / mlp
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparametric_ln
    mlp: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = True

    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_layer_period: int = 1       # MoE FFN every k-th layer (1 = all)

    # SSM
    ssm: str = "none"               # none | mamba1 | mamba2
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64           # mamba2 head dim
    ssm_chunk: int = 256            # chunked-scan length

    # hybrid (zamba2-style): shared full block every k-th ssm block
    shared_attn_period: int = 0     # 0 = no shared blocks
    n_shared_blocks: int = 2        # zamba2 alternates two shared blocks

    # encoder-decoder (whisper-style)
    encoder_layers: int = 0
    cross_attention: bool = False
    encoder_len: int = 1500         # stubbed audio frame count

    # modality frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"

    dtype: str = "bfloat16"         # compute/param dtype
    vocab_round: int = 128          # pad vocab for shardability

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return (self.vocab_size + r - 1) // r * r

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    @property
    def supports_long_context(self) -> bool:
        """True if 500k-token decode is sub-quadratic (SSM/hybrid/SWA)."""
        return self.ssm != "none" or self.attention == "sliding" \
            or self.shared_attn_period > 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """The port model's parameter count, from its shapes on the meta
        device (nothing is allocated)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Parameters a token runs through: the MoE layers' expert matrices
        count ``top_k / num_experts`` of their size."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes of the model-zoo track.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
