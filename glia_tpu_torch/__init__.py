"""glia_tpu_torch: the PyTorch/CUDA port of glia_tpu for NVIDIA Hopper.

The package keeps glia_tpu's module paths so each counterpart is easy to
find.  It imports nothing of glia_tpu or JAX: host modules that the port
needs (numpy / C++) are kept here as its own copies.

Ported so far: 2D inference, ``pipeline.hmt_segment``, with the
classifier in the merge loop (``engine="device_bc"``) or with the
pb-policy merge order on the device and host features
(``engine="device"``).  Two hand-written CUDA kernels: the random-forest
vote walk (``ops/cuda/forest_votes.cu``) and the segment sum
(``ops/cuda/segment_sum.cu``).

Subpackages
-----------
- ``native``   C++ watershed / pre-merge / connected components / exact
               saliency replays (ctypes)
- ``ops``      neighbor and segment ops; ``ops.cuda`` builds and launches
               the kernels
- ``graph``    RAG, merge-order replay, merge trees, the device BC engine,
               the pb-policy device merge engine
- ``features`` feature config, merge-tree features on the host, the
               on-device BC feature assembly
- ``models``   random forest (numpy model, torch walk, CUDA scorer)
- ``infer``    greedy tree resolution and final segmentation
- ``metrics``  VI and adapted Rand
"""

__version__ = "0.1.0"

from .device import default_dtype, resolve_device  # noqa: F401
