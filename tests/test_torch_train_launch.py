"""The port's training driver ``launch/train.py`` against the JAX
package's ``repro.launch.train.main``.

Both run ``--reduced`` (fp32) with 4 clients, 4 rounds and 2 × 32 tokens
a step at the driver's defaults (β 1, κ 0.001, ε 1e-5), the port from the
reference's weights (``model.init(PRNGKey(0))`` carried over by
``convert.load_lm_reference``). The walk visits the same client each
round (the same graph and walker seeds); the summary line is the same;
the losses agree within ``LOSS_TOL``: the reference prints four decimals
(5e-5 of rounding) and the chained steps differ in the last bits of
fp32 (≤ 1e-6 relative on these steps). The ``--ckpt`` file holds y in
the reference's tree: the reference's ``load_pytree`` reads it, its
leaves equal the port's final y and lie within ``Y_TOL`` of the y the
reference saves itself, and ``serve.main --ckpt`` serves from it.
"""
import re

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as ref_load
from repro.configs import get_config as ref_config
from repro.launch import train as ref_train
from repro.models.registry import build_model as ref_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models.registry import build_model
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["--reduced", "--clients", "4", "--rounds", "4", "--batch", "2",
        "--seq", "32"]
LOSS_TOL = dict(atol=1e-4, rtol=0)
# y after four chained steps: the packages' fp32 rounding moves it by
# ≤ 1e-6 relative, and a sign flip of y' − x at a tie moves an element of
# y by 2(z/β + ε)/n (~1e-5 here; see test_torch_train_step)
Y_TOL = dict(atol=2e-5, rtol=1e-5)
ROUND = re.compile(r"round +(\d+)  client +(\d+)  loss +(\S+)  kappa (\S+)")


def _rounds(out: str):
    return [(int(r), int(c), float(loss), kappa)
            for r, c, loss, kappa in ROUND.findall(out)]


def _reference_params(arch):
    return ref_build(ref_config(arch).reduced()).init(jax.random.PRNGKey(0))


def _port_model(arch, params):
    model = build_model(get_config(arch).reduced(), device="cpu")
    convert.load_lm_reference(model, jax.tree_util.tree_map(np.asarray,
                                                            params))
    return model


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-9b"])
def test_train_main_matches_reference(tmp_path, capsys, arch):
    ref_ckpt, ckpt = str(tmp_path / "ref_y.npz"), str(tmp_path / "y.npz")
    ref_train.main(["--arch", arch, *ARGV, "--ckpt", ref_ckpt])
    want = capsys.readouterr().out
    params = _reference_params(arch)
    visits, losses = train.main(
        ["--arch", arch, *ARGV, "--ckpt", ckpt, "--device", "cpu"],
        model=_port_model(arch, params))
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]     # arch, params
    want_rounds, got_rounds = _rounds(want), _rounds(got)
    assert len(want_rounds) == len(got_rounds) == 4
    assert [c for _, c, _, _ in got_rounds] == visits == \
        [c for _, c, _, _ in want_rounds]
    assert [k for *_, k in got_rounds] == [k for *_, k in want_rounds]
    np.testing.assert_allclose(losses, [l for _, _, l, _ in want_rounds],
                               **LOSS_TOL)
    assert f"saved server token to {ckpt}" in got

    # the port's file, read by the reference against its own param tree
    y = ref_load(ckpt, params)
    y_ref = ref_load(ref_ckpt, params)
    for (path, leaf), (_, want_leaf) in zip(
            jax.tree_util.tree_flatten_with_path(y)[0],
            jax.tree_util.tree_flatten_with_path(y_ref)[0]):
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(want_leaf),
                                   err_msg=jax.tree_util.keystr(path),
                                   **Y_TOL)
    # ... and by the port's serve, whose weights are then the token
    served = serve.load_model(arch, reduced=True, device="cpu", ckpt=ckpt)
    for name, p in served.named_parameters():
        np.testing.assert_array_equal(
            p.detach().numpy(),
            convert.lm_state_from_reference(y, served.cfg)[name].numpy())
    ids = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3",
                      "--ckpt", ckpt])
    assert tuple(ids.shape) == (2, 3)


def test_train_main_seeds_its_own_weights(capsys):
    """Without a model the driver builds the reduced config from seed 0:
    two runs print the same rounds; the walk is the reference's."""
    argv = ["--arch", "recurrentgemma-9b", "--reduced", "--clients", "3",
            "--rounds", "3", "--batch", "1", "--seq", "16", "--device",
            "cpu"]
    first = train.main(argv)
    out = capsys.readouterr().out
    assert train.main(argv) == first
    assert len(_rounds(out)) == 3 and "done: 3 rounds" in out
    assert all(np.isfinite(first[1]))


def test_train_main_checks_its_arguments(monkeypatch):
    with pytest.raises(SystemExit):
        train.main(["--arch", "tinyllama-1.1b", "--rounds", "0",
                    "--device", "cpu"])
    model = build_model(get_config("tinyllama-1.1b").reduced(),
                        device="meta")
    with pytest.raises(ValueError, match="--device"):
        train.main(["--arch", "tinyllama-1.1b", "--device", "cpu"],
                   model=model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "tinyllama-1.1b", "--reduced"])
