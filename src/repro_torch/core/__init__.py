"""Paper core: DiSCO-S / DiSCO-F distributed inexact damped Newton."""
from repro_torch.core import comm
from repro_torch.core.disco import (DiscoConfig, DiscoResult, DiscoSolver,
                                    disco_fit, resolve_device)
from repro_torch.core.hvp import (EllOperator, HvpOperator, OperatorCell,
                                  UnsupportedHvpError, cell_id,
                                  make_local_operator, operator_cells,
                                  resolve_cell, validate_solver_cell)
from repro_torch.core.losses import (HUBER, LOGISTIC, LOSSES, POISSON,
                                     QUADRATIC, SQUARED_HINGE, get_loss,
                                     make_huber)
from repro_torch.core.pcg import PCGResult, pcg_features, pcg_samples
from repro_torch.core.preconditioner import (IdentityPreconditioner,
                                             WoodburyPreconditioner)

__all__ = [
    "comm", "DiscoConfig", "DiscoResult", "DiscoSolver", "disco_fit",
    "resolve_device",
    "EllOperator", "HvpOperator", "OperatorCell", "UnsupportedHvpError",
    "cell_id", "make_local_operator", "operator_cells", "resolve_cell",
    "validate_solver_cell",
    "HUBER", "LOGISTIC", "LOSSES", "POISSON", "QUADRATIC", "SQUARED_HINGE",
    "get_loss", "make_huber",
    "PCGResult", "pcg_features", "pcg_samples",
    "IdentityPreconditioner", "WoodburyPreconditioner",
]
