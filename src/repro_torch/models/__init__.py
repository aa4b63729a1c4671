"""The paper's small FL models (MLR, MLP, CNN) as ``nn.Module``s, and the
model zoo's decoder LM (``transformer.LM``, built by
``registry.build_model``)."""
from .small import CNN, MLP, MLR, SmallModel, get_model  # noqa: F401
