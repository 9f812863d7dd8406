"""GLM inference plane: registry, batched scoring, micro-batching, refit.

The port of ``repro.glm_serve``: fitted
:class:`repro_torch.core.disco.DiscoResult` models are published to a
versioned :class:`ModelRegistry` (the reference's on-disk format, so a
version published by either package loads in the other), scored in
micro-batches through K1 ``ell_mv`` (:class:`ScoringEngine` +
:class:`MicroBatchScheduler`), and refreshed by warm-started streamed
refits (:class:`RefitLoop`) without pausing traffic. Every entry point
runs on the card unless given ``device='cpu'``.

Not to be confused with :mod:`repro_torch.serve`, the model zoo's token
decode engines.
"""
from repro_torch.glm_serve.registry import (REGISTRY_VERSION, ModelRegistry,
                                            PublishedModel)
from repro_torch.glm_serve.scoring import (RequestPacker, ScoreRequest,
                                           ScoringEngine, oracle_margins)
from repro_torch.glm_serve.scheduler import (MicroBatchScheduler,
                                             ScoredCompletion, ServeStats)
from repro_torch.glm_serve.refit import RefitLoop

__all__ = [
    "ModelRegistry", "PublishedModel", "REGISTRY_VERSION",
    "RequestPacker", "ScoreRequest", "ScoringEngine", "oracle_margins",
    "MicroBatchScheduler", "ScoredCompletion", "ServeStats",
    "RefitLoop",
]
