"""The float64 run tier on the reduced CNN (c1 = 4, c2 = 8, fc = 32,
dropout on): each baseline for 10 rounds (Walkman 40), both packages
from the reference's state on the reference's cohorts, keys and draws,
every state leaf within ``TOL`` every round. The tier, its tolerance and
the measurement that sets them are ``test_torch_run_float64.py``'s."""
import pytest

from test_torch_run_float64 import feds, run_case
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

__all__ = ["feds"]   # the fixture, found by name in this module


@pytest.mark.parametrize("name", ["fedavg", "perfedavg", "pfedme", "ditto",
                                  "apfl", "walkman"])
def test_baseline_run_matches_reference_in_float64(name, feds):
    run_case(name, "cnn", feds)
