"""Framework-wide constants the PyTorch port reads.

Port of ``fedml_tpu/constants.py``: the same names and values, limited to
what the ported slices use (training plane, simulation backends, FedAvg,
FedOpt).
"""

__version__ = "0.1.0"

TRAINING_PLATFORM_SIMULATION = "simulation"

SIMULATION_BACKEND_SP = "sp"
SIMULATION_BACKEND_PARROT = "parrot"

FED_OPT_FEDAVG = "FedAvg"
FED_OPT_FEDOPT = "FedOpt"
