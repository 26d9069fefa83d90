from .rand import eval_ri
from .vi import eval_vi

__all__ = ["eval_ri", "eval_vi"]
