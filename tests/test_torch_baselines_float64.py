"""One round of each baseline at the paper's full CNN widths, both
packages in float64 (FedAvg, APFL and Walkman; Per-FedAvg, pFedMe and
Ditto are in ``test_torch_baselines_float64_more.py``, so that the test
workers can run the two halves side by side).

Both packages start from the same fp32 initial weights, widened to
float64, and the port is handed the reference's draws: under
``jax.enable_x64`` the reference's ``randint`` and ``bernoulli`` draw
64-bit words, not the ones its fp32 runs (and the port) draw. The
helpers of the round tier come from ``test_torch_baselines.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines as RB
from repro.fl.base import to_device_data as r_device
from repro.models import small as RS
from repro_torch import baselines as TB
from repro_torch import convert
from repro_torch.data import build_federated, pathological_split
from repro_torch.fl.base import to_device_data
from repro_torch.models.small import CNN
from test_torch_baselines import BATCH, COHORT, N_CLIENTS, _numpy, _one_round
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _rows64(tree, lead: int) -> np.ndarray:
    """``convert._flat_rows`` in float64: leaves in layout order."""
    return np.concatenate(
        [np.asarray(a, np.float64).reshape(np.shape(a)[:lead] + (-1,))
         for _, a in convert._walk(_numpy(tree))], axis=-1)


#: the paper's CNN at its published widths (c1 = 16, c2 = 32, fc = 512;
#: P = 1,068,266) on 32 × 32 × 3 images
CIFAR, FULL_KEEP = (32, 32, 3), ((BATCH, 16, 16, 16), (BATCH, 512))
# In fp32 the packages can part at full width on one step: 85-86 % of
# conv2's outputs (5 × 5 × 16 sums) differ in the last bit between the
# reference's convolution and the port's, and where two entries of a
# 2 × 2 max-pool window lie within an ulp, that bit decides which one the
# gradient flows through. In one minibatch of six (seed 0 of
# tests/test_torch_cnn_baselines_probe.py --package gradient) one window
# of 40,960 did so and moved the gradient by 0.2 % of its largest entry;
# the other five agree at 7e-7. At c1 = 4, c2 = 8 the sums agree bit for
# bit, hence the reduced CNN's 1e-6 in ``test_torch_baselines.py``. In
# float64 such near-ties are 2^29 times rarer, so the full-width round is
# held there: every leaf of the six trainers reads at most 5.9e-14 apart
# (FedAvg's weighted sum), well inside atol = rtol = 1e-10.
TOL64 = dict(atol=1e-10, rtol=1e-10)


@pytest.fixture(scope="module")
def cifar_fed():
    from repro.data.synthetic_images import make_cifar_like

    imgs, labels = make_cifar_like(240, seed=0)
    return build_federated(imgs, labels,
                           pathological_split(labels, N_CLIENTS, seed=0))


def full_width_round(name, cifar_fed):
    """The round tier at the paper's CNN widths, both packages in float64
    from the same fp32 initial weights and on the same draws."""
    fed = dataclasses.replace(
        cifar_fed,
        x_train=cifar_fed.x_train.astype(np.float64),
        x_test=cifar_fed.x_test.astype(np.float64))
    data = to_device_data(cifar_fed, "cpu")
    data = data._replace(x_train=data.x_train.double(),
                         x_test=data.x_test.double())
    kw = {} if name == "walkman" else {"clients_per_round": len(COHORT)}
    port = TB.REGISTRY[name](CNN(CIFAR).double(), data, batch_size=BATCH,
                             device="cpu", **kw)
    init = _numpy(RB.REGISTRY[name](RS.make_cnn(CIFAR), r_device(cifar_fed),
                                    batch_size=BATCH, **kw)
                  .init_state(jax.random.PRNGKey(0)))
    state = type(init)._make(jax.tree_util.tree_map(
        lambda a: a.astype(np.float64), tuple(init)))
    port_state = convert.baseline_state_from_reference(name, init)
    port_state = type(port_state)._make(
        t.double() if t.is_floating_point() else t for t in port_state) \
        if name != "walkman" else port_state._replace(
            clients=type(port_state.clients)._make(
                t.double() for t in port_state.clients),
            y=port_state.y.double())
    with jax.enable_x64(True):
        ref = RB.REGISTRY[name](RS.make_cnn(CIFAR), r_device(fed),
                                batch_size=BATCH, **kw)
        r_state = jax.tree_util.tree_map(jnp.asarray, state)
        rounds = _one_round(name, ref, port, r_state, port_state,
                            np.asarray(fed.mask_train.sum(axis=1)),
                            FULL_KEEP, own_draws=False)
        for leaf, got, want, lead in rounds:
            assert got.dtype == torch.float64, leaf
            np.testing.assert_allclose(got.numpy(), _rows64(want, lead),
                                       err_msg=leaf, **TOL64)


@pytest.mark.parametrize("name", ["apfl", "fedavg", "walkman"])
def test_full_width_cnn_round_matches_reference_in_float64(name, cifar_fed):
    full_width_round(name, cifar_fed)
