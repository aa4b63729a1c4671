"""The paper's small FL models (MLR, MLP, CNN) as ``nn.Module``s."""
from .small import CNN, MLP, MLR, SmallModel  # noqa: F401
