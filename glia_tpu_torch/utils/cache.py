"""The store that keeps the multi-phase merge's plans between processes
(counterpart of glia_tpu.utils.cache).

glia_tpu points XLA's persistent compilation cache at a directory, and its
merge keeps a plan store beside the compiled programs
(``glia_plan_memo.json``): the adaptive capacity plans of the pooled-mean
statistic and the depth capacities of the exact saliencies, so that a
fresh process skips the discovery runs.  The port compiles no programs at
run time (its kernels build once into ``.build/``), so of the two only the
plan store remains, and ``enable_persistent_cache`` names its directory.
glia_tpu's ``min_compile_secs`` (the shortest XLA compile worth keeping)
has no counterpart here.  Nothing reads an environment variable: until a
program calls ``enable_persistent_cache``, plans live only in memory.
"""

from __future__ import annotations

import os
from typing import Optional

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".build", "glia_tpu_torch",
    "plan_cache")

_store_dir: list = [None]


def enable_persistent_cache(path: str = REPO_CACHE) -> str:
    """Keep the merge's plan store in ``path`` (default: under the
    repository's ``.build/``, which git ignores), made if missing.  The
    store is read at the next merge that looks for a plan and written
    after every new plan or depth capacity.  Returns ``path``."""
    os.makedirs(path, exist_ok=True)
    _store_dir[0] = path
    return path


def plan_store_dir() -> Optional[str]:
    """The directory named by ``enable_persistent_cache``, or None."""
    return _store_dir[0]
