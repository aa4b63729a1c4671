"""The baseline FL algorithms the paper compares against (§5), ported:
FedAvg, Per-FedAvg (FO), pFedMe, Ditto, APFL, plus Walkman (the closest
ADMM prior, §2)."""
from .apfl import APFLTrainer
from .ditto import DittoTrainer
from .fedavg import FedAvgTrainer
from .perfedavg import PerFedAvgTrainer
from .pfedme import PFedMeTrainer
from .walkman_trainer import WalkmanTrainer

REGISTRY = {
    "fedavg": FedAvgTrainer,
    "perfedavg": PerFedAvgTrainer,
    "pfedme": PFedMeTrainer,
    "ditto": DittoTrainer,
    "apfl": APFLTrainer,
    "walkman": WalkmanTrainer,
}



def get_baseline(name: str):
    """The trainer class of baseline ``name`` (any case)."""
    try:
        return REGISTRY[name.lower()]
    except KeyError as e:
        raise ValueError(
            f"unknown baseline {name!r}; options: {sorted(REGISTRY)}"
        ) from e
