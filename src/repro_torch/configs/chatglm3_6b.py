"""chatglm3-6b [dense] — 2d (partial) RoPE, extreme GQA. [arXiv:2406.12793]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", arch_type="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=65024, head_dim=128,
        attention="full", rope="partial", rope_fraction=0.5,
        qkv_bias=True, norm="rmsnorm", mlp="swiglu", tie_embeddings=False)


def smoke() -> ModelConfig:
    return config().replace(num_layers=2, d_model=128, num_heads=4,
                            num_kv_heads=2, head_dim=32, d_ff=256,
                            vocab_size=512, dtype="float32")
