"""LLM token-decode serving over the port's dense, MoE, SSM and hybrid
decoders (``repro/serve``)."""
from repro_torch.serve.engine import (Completion, Engine, Request,
                                      make_serve_step)
from repro_torch.serve.scheduler import ContinuousEngine

__all__ = ["Engine", "Request", "Completion", "make_serve_step",
           "ContinuousEngine"]
