"""The paper's experimental models (App. D.1) as ``nn.Module``s:

  * MLR — multinomial logistic regression (strongly convex setting),
  * MLP — two hidden dense layers, cross-entropy,
  * CNN — two 5×5 conv layers + FC-512 + softmax, dropout 25% / 50%.

Port of ``repro/models/small.py`` that keeps the reference's public
layout, so flat parameter vectors and inputs compare directly:

* inputs are NHWC; the CNN permutes to NCHW for ``conv2d`` and back to
  NHWC before flattening, so ``fc.w`` keeps the (h, w, c) row order;
* conv weights are HWIO ``(5, 5, c_in, c_out)`` and dense weights
  ``(n_in, n_out)``; the conv permutes its weight to OIHW as a view.

Parameter names are ``<layer>.w`` / ``<layer>.b``, the keys of the flat
layout (``core/tree.py``). Dropout takes keep masks that the caller draws
from threefry keys, the bits the reference's ``bernoulli(fold_in(rng, i),
p, shape)`` draws (per-client gradients under ``vmap`` draw them
outside): :meth:`SmallModel.keep_masks` describes them for the trainers'
fused draw, :meth:`SmallModel.draw_keep` draws them alone;
``train=False`` turns it off.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng


class _Dense(nn.Module):
    def __init__(self, n_in: int, n_out: int, scale: float | None = None):
        super().__init__()
        self.scale = scale if scale is not None else math.sqrt(2.0 / n_in)
        self.w = nn.Parameter(torch.empty(n_in, n_out))
        self.b = nn.Parameter(torch.zeros(n_out))

    def init_params(self, key: torch.Tensor) -> dict[str, torch.Tensor]:
        """The reference's ``_dense_init``: ``normal(split(key)[0])``."""
        return {"w": prng.normal(prng.split(key)[0], self.w.shape)
                * self.scale, "b": torch.zeros(self.b.shape)}

    def forward(self, x):
        return x @ self.w + self.b


class _Conv5(nn.Module):
    """5×5 'SAME' convolution with an HWIO weight on NCHW activations."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.scale = math.sqrt(2.0 / (5 * 5 * c_in))
        self.w = nn.Parameter(torch.empty(5, 5, c_in, c_out))
        self.b = nn.Parameter(torch.zeros(c_out))

    def init_params(self, key: torch.Tensor) -> dict[str, torch.Tensor]:
        """``normal(key)`` in HWIO, with no split (the reference's CNN)."""
        return {"w": prng.normal(key, self.w.shape) * self.scale,
                "b": torch.zeros(self.b.shape)}

    def forward(self, x):
        return F.conv2d(x, self.w.permute(3, 2, 0, 1), self.b, padding=2)


class SmallModel(nn.Module):
    """Common interface: ``forward(x, *, train, keep)`` and
    :meth:`init_params`, which draws a fresh parameter dict (module
    names, CPU, fp32) from a threefry key without touching the module."""

    name = "small"
    convex = False
    #: keep probability of each dropout layer, in forward order
    keep_probs: tuple[float, ...] = ()

    def _finish_init(self):
        """Fill the module's own parameters from seed 0 (training draws
        its init through :meth:`init_params` with the run's seed)."""
        with torch.no_grad():
            params = self.init_params(prng.prng_key(0))
            for name, p in self.named_parameters():
                p.copy_(params[name])

    def init_params(self, key: torch.Tensor) -> dict[str, torch.Tensor]:
        """The reference's ``model.init(key)`` along its key tree: one
        layer takes ``key`` itself, several take ``split(key, n)`` in
        order. Draw on the CPU: ``erf_inv`` may round otherwise on
        another device, and a seed must give the same weights on all."""
        layers = list(self.named_children())
        keys = [key] if len(layers) == 1 else prng.split(key, len(layers))
        out = {}
        for (name, layer), k in zip(layers, keys):
            for leaf, v in layer.init_params(k).items():
                out[f"{name}.{leaf}"] = v
        return out

    def dropout_shapes(self, batch: int) -> tuple[tuple[int, ...], ...]:
        """The reference's (NHWC) activation shapes of the dropout layers
        for a batch: the shapes its masks are drawn in."""
        return ()

    def keep_masks(self, batch: int) -> tuple[prng.MaskSpec, ...]:
        """Every dropout layer's keep mask for a batch: its reference
        shape and keep probability, and the layout :meth:`forward`
        applies it in."""
        return tuple(prng.MaskSpec(shape, p)
                     for shape, p in zip(self.dropout_shapes(batch),
                                         self.keep_probs))

    def draw_keep(self, keys: torch.Tensor, batch: int
                  ) -> tuple[torch.Tensor, ...]:
        """Keep masks for every dropout layer under each key of ``keys``
        ``(..., 2)``: layer i draws ``bernoulli(fold_in(key, i + 1), p,
        shape)`` in the reference's shape, laid out as :meth:`forward`
        applies it; ``(...,)`` leads each mask."""
        return prng.draws(keys, masks=self.keep_masks(batch))[1]


def _dropout(x, keep, p):
    return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


class MLR(SmallModel):
    name, convex = "mlr", True

    def __init__(self, input_shape, n_classes: int = 10):
        super().__init__()
        self.linear = _Dense(math.prod(input_shape), n_classes, scale=0.01)
        self._finish_init()

    def forward(self, x, *, train=False, keep=None):
        return self.linear(x.reshape(x.shape[0], -1))


class MLP(SmallModel):
    name = "mlp"

    def __init__(self, input_shape, n_classes: int = 10, hidden: int = 100):
        super().__init__()
        n_in = math.prod(input_shape)
        self.fc1 = _Dense(n_in, hidden)
        self.fc2 = _Dense(hidden, hidden)
        self.out = _Dense(hidden, n_classes)
        self._finish_init()

    def forward(self, x, *, train=False, keep=None):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        return self.out(x)


class CNN(SmallModel):
    name = "cnn"
    keep_probs = (0.75, 0.5)

    def __init__(self, input_shape, n_classes: int = 10, c1: int = 16,
                 c2: int = 32, fc: int = 512):
        super().__init__()
        h, w, c_in = input_shape
        self.hw = (h, w)
        self.widths = (c1, fc)
        self.conv1 = _Conv5(c_in, c1)
        self.conv2 = _Conv5(c1, c2)
        self.fc = _Dense((h // 4) * (w // 4) * c2, fc)
        self.out = _Dense(fc, n_classes)
        self._finish_init()

    def dropout_shapes(self, batch: int):
        (h, w), (c1, fc) = self.hw, self.widths
        return ((batch, h // 2, w // 2, c1), (batch, fc))

    def keep_masks(self, batch: int):
        # The conv block's mask is drawn NHWC (the bits follow the flat
        # index) and stored NCHW, as its activations are.
        conv, dense = super().keep_masks(batch)
        return conv._replace(channels_first=True), dense

    def forward(self, x, *, train=False, keep=None):
        drop = train and keep is not None
        x = x.permute(0, 3, 1, 2)                       # NHWC → NCHW
        x = F.max_pool2d(torch.relu(self.conv1(x)), 2)
        if drop:                                        # 25% after block 1
            x = _dropout(x, keep[0], self.keep_probs[0])
        x = F.max_pool2d(torch.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) rows
        x = torch.relu(self.fc(x))
        if drop:                                        # 50% before the head
            x = _dropout(x, keep[1], self.keep_probs[1])
        return self.out(x)


def get_model(name: str, input_shape, n_classes: int = 10) -> SmallModel:
    """The paper's model by name (``mlr``, ``mlp`` or ``cnn``) at its
    published widths."""
    models = {"mlr": MLR, "mlp": MLP, "cnn": CNN}
    if name.lower() not in models:
        raise ValueError(f"unknown small model {name!r}")
    return models[name.lower()](input_shape, n_classes)


# ------------------------------------------------------------- losses -----
def cross_entropy(logits, labels, mask=None):
    """Mean negative log-likelihood; with ``mask``, over masked rows."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1))[..., 0]
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def accuracy(logits, labels, mask=None):
    hit = (torch.argmax(logits, dim=-1) == labels).to(torch.float32)
    if mask is None:
        return hit.mean()
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)
