"""xLSTM-350M [arXiv:2405.04517] — sLSTM + mLSTM blocks (assignment:
24L, d=1024, 4 heads). Pattern: one sLSTM per five mLSTM blocks (the
paper's [7:1]-style sparse sLSTM placement, adapted to 24 layers)."""
from .base import ModelConfig, register

_PATTERN = ("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm")  # ×4 = 24

XLSTM_350M = register(ModelConfig(
    arch_id="xlstm-350m",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,          # xLSTM blocks carry their own up-projections
    vocab=50304,
    layer_pattern=_PATTERN,
    rope="none",
    act="gelu",
    source="arXiv:2405.04517",
))
