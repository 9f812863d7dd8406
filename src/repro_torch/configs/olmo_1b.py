"""olmo-1b [dense] — non-parametric LayerNorm. [arXiv:2402.00838]

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", arch_type="dense",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=50304, head_dim=128,
        attention="full", rope="standard",
        norm="nonparametric_ln", mlp="swiglu", tie_embeddings=True)


def smoke() -> ModelConfig:
    return config().replace(num_layers=2, d_model=128, num_heads=4,
                            num_kv_heads=4, head_dim=32, d_ff=512,
                            vocab_size=512, dtype="float32")
