"""Paper core: DiSCO-S / DiSCO-F distributed inexact damped Newton, the
workloads on it (λ-path sweeps, multinomial softmax) and the paper's
baselines (:mod:`repro_torch.core.baselines`)."""
from repro_torch.core import comm
from repro_torch.core.disco import (DiscoConfig, DiscoResult, DiscoSolver,
                                    disco_fit, disco_fit_streaming,
                                    resolve_device)
from repro_torch.core.glm import GLMProblem
from repro_torch.core.hvp import (DenseKernelOperator, DenseOperator,
                                  EllOperator, HvpOperator, OperatorCell,
                                  SoftmaxHvpOperator, StreamedHvpOperator,
                                  UnsupportedHvpError, cell_id,
                                  make_local_operator, operator_cells,
                                  render_support_matrix, resolve_cell,
                                  validate_solver_cell)
from repro_torch.core.losses import (HUBER, LOGISTIC, LOSSES, POISSON,
                                     QUADRATIC, SQUARED_HINGE, get_loss,
                                     make_huber)
from repro_torch.core.lambda_path import (LambdaPathResult, lambda_path_fit,
                                          validation_loss, x_passes)
from repro_torch.core.pcg import (PCGResult, pcg_features, pcg_samples,
                                  pcg_streamed)
from repro_torch.core.preconditioner import (IdentityPreconditioner,
                                             WoodburyPreconditioner,
                                             sag_solve)
from repro_torch.core.softmax import (SoftmaxConfig, SoftmaxProblem,
                                      SoftmaxResult, SoftmaxSolver,
                                      softmax_fit)

__all__ = [
    "comm", "DiscoConfig", "DiscoResult", "DiscoSolver",
    "disco_fit", "disco_fit_streaming", "resolve_device", "GLMProblem",
    "DenseKernelOperator", "DenseOperator", "EllOperator", "HvpOperator",
    "OperatorCell", "SoftmaxHvpOperator", "StreamedHvpOperator",
    "UnsupportedHvpError", "cell_id", "make_local_operator",
    "operator_cells", "render_support_matrix", "resolve_cell",
    "validate_solver_cell",
    "HUBER", "LOGISTIC", "LOSSES", "POISSON", "QUADRATIC", "SQUARED_HINGE",
    "get_loss", "make_huber",
    "LambdaPathResult", "lambda_path_fit", "validation_loss", "x_passes",
    "PCGResult", "pcg_features", "pcg_samples", "pcg_streamed",
    "IdentityPreconditioner", "WoodburyPreconditioner", "sag_solve",
    "SoftmaxConfig", "SoftmaxProblem", "SoftmaxResult", "SoftmaxSolver",
    "softmax_fit",
]
