"""PyTorch/CUDA port of the DiSCO solver and of the model zoo's dense, MoE,
SSM and hybrid decoders (the JAX package ``repro`` is the reference it is held
against).

Imports ``torch`` and never ``jax``, and nothing of ``repro``. The
entry points (:func:`disco_fit`, :class:`DiscoSolver` and its streamed
(out-of-core) form :meth:`DiscoSolver.from_store` /
:func:`disco_fit_streaming`,
:func:`lambda_path_fit`, :func:`softmax_fit`, :class:`SoftmaxSolver`, and
the paper's baselines :func:`gd_fit`, :func:`dane_fit`, :func:`cocoa_fit`)
run on the card unless the caller passes ``device='cpu'``. Input is a sparse
:class:`CSRMatrix` or a dense ``(d, n)`` array or tensor; on the card
every HVP of PCG, classic or s-step (``pcg_block_s > 1``), goes through
the hand-written Hopper kernels of :mod:`repro_torch.kernels` (for dense
input with ``use_kernel=True``). :func:`load_libsvm_sparse` and
:func:`load_libsvm` read the paper's libsvm files. The shards of a solve
live in one process (:class:`InProcessGroup`) or one a process
(:class:`DistributedGroup`, ``torch.distributed``; the in-memory DiSCO
solve, the λ-path and the baselines).

The dense decoders (olmo-1b, chatglm3-6b, phi3-medium-14b, qwen2.5-32b)
and the MoE decoders (mixtral-8x7b, qwen3-moe-30b-a3b: top-k routing,
per-row capacity dispatch in prefill, token-choice decode), the SSM
decoder falcon-mamba-7b (Mamba1) and the hybrid zamba2-2.7b (Mamba2 with
shared attention blocks), from
:func:`get_config`, are served by :func:`init_params`, :func:`forward`
(prefill, every layer's attention on the hand-written flash kernel),
:func:`init_cache` / :func:`decode_step`, :class:`Engine` and
:class:`ContinuousEngine`, and ``python -m repro_torch.launch.serve``;
they too run on the card unless given ``device='cpu'``.
"""
from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.core.baselines import (CocoaConfig, DaneConfig, GDConfig,
                                        cocoa_fit, dane_fit, gd_fit)
from repro_torch.core.disco import (DiscoConfig, DiscoResult, DiscoSolver,
                                    disco_fit, disco_fit_streaming)
from repro_torch.core.glm import GLMProblem
from repro_torch.core.lambda_path import LambdaPathResult, lambda_path_fit
from repro_torch.core.softmax import (SoftmaxConfig, SoftmaxResult,
                                      SoftmaxSolver, softmax_fit)
from repro_torch.data.libsvm import load_libsvm, save_libsvm
from repro_torch.data.sparse import (CSRMatrix, load_libsvm_sparse,
                                     make_sparse_glm_data)
from repro_torch.data.synthetic import make_glm_data
from repro_torch.models import decode_step, forward, init_cache, init_params
from repro_torch.parallel.collectives import (DistributedGroup,
                                              InProcessGroup)
from repro_torch.serve import ContinuousEngine, Engine, Request

__all__ = ["DiscoConfig", "DiscoResult", "DiscoSolver", "disco_fit",
           "disco_fit_streaming",
           "GLMProblem", "LambdaPathResult", "lambda_path_fit",
           "SoftmaxConfig", "SoftmaxResult", "SoftmaxSolver", "softmax_fit",
           "GDConfig", "gd_fit", "DaneConfig", "dane_fit", "CocoaConfig",
           "cocoa_fit", "CSRMatrix", "load_libsvm", "load_libsvm_sparse",
           "save_libsvm", "make_sparse_glm_data", "make_glm_data",
           "InProcessGroup", "DistributedGroup", "ModelConfig", "get_config",
           "get_smoke_config",
           "init_params", "forward", "init_cache", "decode_step", "Engine",
           "ContinuousEngine", "Request"]
