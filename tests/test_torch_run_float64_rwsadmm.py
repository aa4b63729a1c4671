"""The float64 run tier of RWSADMM's round: the single walker's zone
rounds on the reference's schedule (walk, zones, round keys), both
packages from the reference's x, z and y, the port handed the
reference's draws. ``closed_form`` runs the eager update
(``core.rwsadmm.client_round`` and the masked fold) and the
``scan_fused`` round through the zone kernel's plain version
(``kernels/rwsadmm_update/ref.py``), ``prox_sgd`` its ten
sub-gradient steps; x, z and y within ``TOL`` every round, ``visited``
and κ equal. The tier, its tolerance and the measurement that sets them
are ``test_torch_run_float64.py``'s."""
import pytest

from test_torch_run_float64 import feds, run_case
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

__all__ = ["feds"]   # the fixture, found by name in this module


@pytest.mark.parametrize("kind", ["mlr", "mlp", "cnn"])
@pytest.mark.parametrize("solver", ["closed_form", "prox_sgd"])
def test_walker_run_matches_reference_in_float64(solver, kind, feds):
    run_case(solver, kind, feds)
