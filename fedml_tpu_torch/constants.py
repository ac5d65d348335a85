"""Framework-wide constants the PyTorch port reads.

Port of ``fedml_tpu/constants.py``: the same names and values, limited to
what the ported slices use (training planes, simulation backends, the
cross-silo scenarios, and the optimizers the port runs or names when it
refuses them).
"""

__version__ = "0.1.0"

TRAINING_PLATFORM_SIMULATION = "simulation"
TRAINING_PLATFORM_CROSS_SILO = "cross_silo"

SIMULATION_BACKEND_SP = "sp"
SIMULATION_BACKEND_PARROT = "parrot"
SIMULATION_BACKEND_MESH = "mesh"
SIMULATION_BACKEND_HYPERSCALE = "hyperscale"

CROSS_SILO_SCENARIO_HORIZONTAL = "horizontal"
CROSS_SILO_SCENARIO_HIERARCHICAL = "hierarchical"

FED_OPT_FEDAVG = "FedAvg"
FED_OPT_FEDAVG_SEQ = "FedAvg_seq"
FED_OPT_FEDOPT = "FedOpt"
FED_OPT_FEDPROX = "FedProx"
FED_OPT_FEDNOVA = "FedNova"
FED_OPT_FEDDYN = "FedDyn"
FED_OPT_SCAFFOLD = "SCAFFOLD"
FED_OPT_MIME = "Mime"
FED_OPT_HIERARCHICAL = "HierarchicalFL"
FED_OPT_VERTICAL = "VerticalFL"
FED_OPT_SPLIT_NN = "SplitNN"
FED_OPT_ASYNC_FEDAVG = "Async_FedAvg"
FED_OPT_DECENTRALIZED = "Decentralized"
FED_OPT_SECAGG = "SA"
FED_OPT_LIGHTSECAGG = "LSA"
