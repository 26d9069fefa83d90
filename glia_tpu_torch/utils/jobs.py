"""Process-pool job runner (a copy of glia_tpu.utils.jobs; the
reference's orchestration layer, code/gadget/python/script_util.py:6-23:
a polling subprocess pool running shell commands with a concurrency cap,
aborting the batch on any nonzero exit).  For running CLI-stage
pipelines out of process; in-memory pipelines call
glia_tpu_torch.pipeline.
"""

from __future__ import annotations

import subprocess
import time
from typing import List, Sequence


def execute(jobs: Sequence[str], nproc: int = 1, poll_s: float = 0.1,
            env=None, check=True) -> List[int]:
    """Run shell-command jobs with at most ``nproc`` concurrent processes.

    Returns exit codes (in job order); raises on the first failure when
    ``check`` (script_util.py:14-16 exits the batch on any nonzero child).
    """
    t0 = time.time()
    pending = list(enumerate(jobs))
    running: List = []
    codes = [None] * len(jobs)
    try:
        while pending or running:
            while pending and len(running) < nproc:
                i, cmd = pending.pop(0)
                running.append((i, subprocess.Popen(cmd, shell=True,
                                                    env=env)))
            still = []
            for i, p in running:
                rc = p.poll()
                if rc is None:
                    still.append((i, p))
                else:
                    codes[i] = rc
                    if check and rc != 0:
                        raise RuntimeError(
                            f"job {i} failed with exit code {rc}: {jobs[i]}")
            running = still
            if running:
                time.sleep(poll_s)
    finally:
        for _, p in running:
            p.terminate()
            p.wait()
    print(f"[jobs] {len(jobs)} jobs in {time.time() - t0:.1f}s")
    return codes
