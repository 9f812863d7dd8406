"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attn. [arXiv:2401.04088]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA.
SWA (window 4096) bounds the KV cache, so this arch carries the long_500k
decode shape.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", arch_type="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        attention="sliding", window=4096, rope="standard",
        rope_theta=1e6, norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
        moe=True, num_experts=8, top_k=2)


def smoke() -> ModelConfig:
    return config().replace(num_layers=2, d_model=128, num_heads=4,
                            num_kv_heads=2, head_dim=32, d_ff=256,
                            vocab_size=512, num_experts=4, top_k=2,
                            window=64, dtype="float32")
