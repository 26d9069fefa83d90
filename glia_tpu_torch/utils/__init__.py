from .cache import enable_persistent_cache
from .checkpoint import StageStore, restore_params, save_params
from .jobs import execute
from .profiling import StageTimer, block_and_time, trace
