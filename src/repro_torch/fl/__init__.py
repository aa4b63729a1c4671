"""Federated-learning runtime: device data layout, trainers, simulation."""
from .base import DeviceData, TrainerBase, to_device_data  # noqa: F401
from .fleet_trainer import FleetRWSADMMTrainer  # noqa: F401
from .rwsadmm_trainer import RWSADMMTrainer  # noqa: F401
from .simulation import run_simulation  # noqa: F401
