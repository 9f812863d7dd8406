"""falcon-mamba-7b [ssm] — attention-free Mamba1. [arXiv:2410.05355]

64L d_model=4096 (attn-free) vocab=65024, ssm_state=16, expand 2
(d_inner=8192). Sub-quadratic: carries the long_500k decode shape.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b", arch_type="ssm",
        num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=65024, head_dim=0,
        attention="none", rope="none",
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
        ssm="mamba1", ssm_state=16, ssm_conv=4, ssm_expand=2)


def smoke() -> ModelConfig:
    return config().replace(num_layers=2, d_model=128, vocab_size=512,
                            ssm_chunk=32, dtype="float32")
