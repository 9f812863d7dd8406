"""The model zoo's dense, MoE, SSM and hybrid decoders in PyTorch
(``repro/models``)."""
from repro_torch.models.model import (DecoderLM, count_params_analytic,
                                      decode_step, forward, init_cache,
                                      init_params)

__all__ = ["DecoderLM", "init_params", "forward", "decode_step",
           "init_cache", "count_params_analytic"]
