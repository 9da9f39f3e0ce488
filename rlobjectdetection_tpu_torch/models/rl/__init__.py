from .action import Action
from .policy import RLPolicyNet, warm_start_from_detector

__all__ = ["Action", "RLPolicyNet", "warm_start_from_detector"]
