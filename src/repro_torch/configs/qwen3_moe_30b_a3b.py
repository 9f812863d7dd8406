"""qwen3-moe-30b-a3b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert) vocab=151936,
MoE 128e top-8, head_dim=128 (q_dim 4096 > d_model, per the model card).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", arch_type="moe",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
        d_ff=768, vocab_size=151936, head_dim=128,
        attention="full", rope="standard", rope_theta=1e6,
        norm="rmsnorm", mlp="swiglu", tie_embeddings=False,
        moe=True, num_experts=128, top_k=8)


def smoke() -> ModelConfig:
    return config().replace(num_layers=2, d_model=128, num_heads=4,
                            num_kv_heads=2, head_dim=32, d_ff=64,
                            vocab_size=512, num_experts=4, top_k=2,
                            dtype="float32")
