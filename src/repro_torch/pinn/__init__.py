"""PINN training framework: differential-operator subsystem (multi-PDE) plus
the paper's self-similar Burgers profiles (section IV-C)."""

from .burgers import (exact_profile, lambda_window, profile_lambda,
                      residual_derivs_autodiff, residual_jet, smoothness_order)
from .losses import (LossWeights, bc_targets, burgers_pinn_loss, pinn_loss,
                     residual_jet_u)
from .operators import (DerivTable, Operator, autodiff_mixed_partial_fn,
                        autodiff_pure_derivs_fn, build_table, burgers_operator,
                        check_net_matches, exact_values, get_operator,
                        ntp_pure_derivs, operator_names, register,
                        residual_of_fn, residual_values)
from .trainer import (OperatorResult, OperatorRunConfig, PINNResult,
                      PINNRunConfig, train, train_operator)
