"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219]

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b", arch_type="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10,
        d_ff=17920, vocab_size=100352, head_dim=128,
        attention="full", rope="standard",
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False)


def smoke() -> ModelConfig:
    return config().replace(num_layers=2, d_model=160, num_heads=5,
                            num_kv_heads=5, head_dim=32, d_ff=256,
                            vocab_size=512, dtype="float32")
