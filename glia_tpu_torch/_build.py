"""Build native shared libraries at first use.

Outputs go to ``.build/glia_tpu_torch/`` beside the package (a directory
git ignores), never next to the sources.  Each library's file name carries
a hash of its sources and compiler command, so an edited source is rebuilt
and concurrent processes (test workers) never load a half-written file:
each compiles to a private temporary name and renames it into place.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from typing import List, Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_ROOT, ".build", "glia_tpu_torch")


class SharedLibBuild:
    """One compiler run producing one shared library.  ``start`` launches
    the compiler without waiting, so several builds can run at once;
    ``wait`` returns the library path or raises with the compiler output."""

    def __init__(self, name: str, sources: Sequence[str],
                 command: Sequence[str]):
        h = hashlib.sha1(" ".join(command).encode())
        for src in sources:
            with open(src, "rb") as f:
                h.update(f.read())
        self.path = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:12]}.so")
        self._tmp = f"{self.path}.{os.getpid()}.tmp"
        self._argv: List[str] = [*command, "-o", self._tmp, *sources]
        self._proc: Optional[subprocess.Popen] = None
        self.log = ""

    def start(self) -> "SharedLibBuild":
        if self._proc is None and not os.path.exists(self.path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            self._proc = subprocess.Popen(
                self._argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        return self

    def wait(self) -> str:
        self.start()
        if self._proc is not None:
            out, _ = self._proc.communicate()
            self.log = out
            if self._proc.returncode != 0:
                raise RuntimeError(
                    f"build of {self.path} failed "
                    f"({' '.join(self._argv)}):\n{out}")
            os.replace(self._tmp, self.path)
            self._proc = None
        return self.path
