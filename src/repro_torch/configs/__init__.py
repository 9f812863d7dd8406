"""Registry of the model configurations the port runs.

The dense, MoE, SSM (Mamba1) and hybrid (Mamba2 with shared attention)
decoders are ported (:data:`ARCHS`); the JAX package's other
architectures (audio, VLM) raise "not yet ported".
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig

ARCHS = ["olmo_1b", "chatglm3_6b", "phi3_medium_14b", "qwen2_5_32b",
         "mixtral_8x7b", "qwen3_moe_30b_a3b", "falcon_mamba_7b",
         "zamba2_2_7b"]
NOT_YET_PORTED = ["whisper_medium", "qwen2_vl_72b"]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS + NOT_YET_PORTED}
_ALIAS.update({"qwen2.5-32b": "qwen2_5_32b", "zamba2-2.7b": "zamba2_2_7b"})


def _module(name: str):
    mod_name = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not yet ported to repro_torch (the "
            f"audio and VLM families are still to come; ported: "
            f"{', '.join(ARCHS)})")
    if mod_name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()


def list_archs() -> list[str]:
    return list(ARCHS)


__all__ = ["ModelConfig", "InputShape", "INPUT_SHAPES", "ARCHS",
           "NOT_YET_PORTED", "get_config", "get_smoke_config", "list_archs"]
