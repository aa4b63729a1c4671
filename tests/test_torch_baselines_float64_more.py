"""One round of Per-FedAvg, pFedMe and Ditto at the paper's full CNN
widths, both packages in float64: the second half of
``test_torch_baselines_float64.py``, whose fixture and round it runs."""
import pytest

from test_torch_baselines_float64 import cifar_fed, full_width_round
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

__all__ = ["cifar_fed"]   # the fixture, found by name in this module


@pytest.mark.parametrize("name", ["ditto", "perfedavg", "pfedme"])
def test_full_width_cnn_round_matches_reference_in_float64(name, cifar_fed):
    full_width_round(name, cifar_fed)
