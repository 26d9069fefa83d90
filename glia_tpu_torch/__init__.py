"""glia_tpu_torch: the PyTorch/CUDA port of glia_tpu for NVIDIA Hopper.

The package keeps glia_tpu's module paths so each counterpart is easy to
find.  It imports nothing of glia_tpu or JAX: host modules that the port
needs (numpy / C++) are kept here as its own copies.

Ported so far: classifier-in-the-loop 2D inference,
``pipeline.hmt_segment(engine="device_bc")``, with the random-forest vote
walk as a hand-written CUDA kernel (``ops/cuda/forest_votes.cu``).

Subpackages
-----------
- ``native``   C++ watershed / pre-merge / connected components (ctypes)
- ``ops``      neighbor ops; ``ops.cuda`` builds and launches the kernels
- ``graph``    RAG, merge-order replay, merge trees, the device BC engine
- ``features`` feature config and the on-device BC feature assembly
- ``models``   random forest (numpy model, torch walk, CUDA scorer)
- ``infer``    greedy tree resolution and final segmentation
- ``metrics``  VI and adapted Rand
"""

__version__ = "0.1.0"

from .device import default_dtype, resolve_device  # noqa: F401
