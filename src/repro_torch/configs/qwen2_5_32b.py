"""qwen2.5-32b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", arch_type="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=27648, vocab_size=152064, head_dim=128,
        attention="full", rope="standard", rope_theta=1e6, qkv_bias=True,
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False)


def smoke() -> ModelConfig:
    return config().replace(num_layers=2, d_model=128, num_heads=4,
                            num_kv_heads=2, head_dim=32, d_ff=256,
                            vocab_size=512, dtype="float32")
