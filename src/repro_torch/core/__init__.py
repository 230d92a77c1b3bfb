"""Core n-TangentProp in PyTorch: jets, Faa di Bruno tables, activation
derivative stacks, the jet-module layer, networks and derivative engines."""

from . import jet, modules, taylor
from .activations import TAYLOR_STACKS, tanh_taylor_stack
from .baselines import taylor_jet_derivatives
from .engines import (AutodiffEngine, DerivativeEngine, EngineSpec, JetEngine,
                      NTPEngine)
from .jet import Jet
from .modules import (Activation, CoordinateEmbedding, Dense, FourierFeatures,
                      MLPBlock, Module, Residual, RMSNorm, SelfAttention,
                      Sequential, TokenPool, make_module, module_names,
                      register_module)
from .network import (DenseMLP, FourierFeatureMLP, MLP, Network, ResidualMLP,
                      Transformer, make_network, network_names,
                      register_network)
from .ntp import (MLPParams, cross, init_mlp, mlp_apply, ntp_derivatives,
                  ntp_forward, ntp_grid, ntp_jet)
from .partitions import (bell_number, faa_di_bruno_table, partition_count,
                         partitions, raw_bell_coefficient, total_fdb_terms)

__all__ = [
    "jet", "Jet", "modules", "taylor", "TAYLOR_STACKS", "tanh_taylor_stack",
    "taylor_jet_derivatives",
    "AutodiffEngine", "DerivativeEngine", "EngineSpec", "JetEngine", "NTPEngine",
    "Activation", "CoordinateEmbedding", "Dense", "FourierFeatures", "MLPBlock",
    "Module", "Residual", "RMSNorm", "SelfAttention", "Sequential", "TokenPool",
    "make_module", "module_names", "register_module",
    "DenseMLP", "FourierFeatureMLP", "MLP", "Network", "ResidualMLP",
    "Transformer", "make_network",
    "network_names", "register_network",
    "MLPParams", "cross", "init_mlp", "mlp_apply", "ntp_derivatives",
    "ntp_forward", "ntp_grid", "ntp_jet",
    "bell_number", "faa_di_bruno_table", "partition_count", "partitions",
    "raw_bell_coefficient", "total_fdb_terms",
]
