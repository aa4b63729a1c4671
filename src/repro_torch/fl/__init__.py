"""Federated-learning runtime: device data layout, trainer, simulation."""
