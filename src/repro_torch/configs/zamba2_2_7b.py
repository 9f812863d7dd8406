"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attn blocks.
[arXiv:2411.15242]

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Two shared transformer blocks alternate every 6 Mamba2 blocks (9
invocations); each invocation has its own concat-projection (Zamba2's
per-invocation LoRA simplified to a full projection — DESIGN.md §6).
Shared attention uses a 4096 sliding window at decode so the 500k-token
shape is carried by the Mamba2 state.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", arch_type="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=10240, vocab_size=32000, head_dim=80,
        attention="sliding", window=4096, rope="standard",
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
        ssm="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2,
        ssm_headdim=64, shared_attn_period=6, n_shared_blocks=2)


def smoke() -> ModelConfig:
    return config().replace(num_layers=4, d_model=128, num_heads=4,
                            num_kv_heads=4, head_dim=32, d_ff=256,
                            vocab_size=512, ssm_state=16, ssm_headdim=32,
                            ssm_chunk=32, shared_attn_period=2,
                            window=64, dtype="float32")
