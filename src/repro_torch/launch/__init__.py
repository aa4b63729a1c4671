"""Serving steps and the serving entry point of the model zoo."""
