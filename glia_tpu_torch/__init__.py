"""glia_tpu_torch: the PyTorch/CUDA port of glia_tpu for NVIDIA Hopper.

The package keeps glia_tpu's module paths so each counterpart is easy to
find.  It imports nothing of glia_tpu or JAX: host modules that the port
needs (numpy / C++) are kept here as its own copies.

Ported so far: 2D training and inference, ``pipeline.hmt_segment``
with the classifier in the merge loop (``engine="device_bc"``), the
pb-policy merge order on the device (``engine="device"``) or the serial
C++ one (``engine="host"``); the stack pipelines (``pipeline3d``: 3D HMT
on a volume, LINK3D across sections); the file-bus CLI
(``python -m glia_tpu_torch.cli``).  Two hand-written CUDA kernels: the
random-forest vote walk (``ops/cuda/forest_votes.cu``) and the segment
sum (``ops/cuda/segment_sum.cu``).

Subpackages
-----------
- ``native``   C++ watershed / pre-merge / connected components / exact
               saliency replays / serial merges / CART training (ctypes)
- ``io``       image / text artifact IO (file-bus compatible, plus .npy)
- ``ops``      neighbor, segment and image ops; ``ops.cuda`` builds and
               launches the kernels
- ``graph``    RAG, merge engines (host and device), merge trees
- ``features`` feature config, shape moments, merge-tree features on the
               host, the on-device BC feature assembly, labels
- ``models``   random forest (numpy model, torch walk, CUDA scorer), MLP,
               ensembles
- ``learn``    DNF energies, SSHMT training, predictors
- ``infer``    greedy / CCM tree resolution and final segmentation
- ``metrics``  VI and Rand (host and device)
- ``link3d``   section-to-section linking of 2D segmentations into 3D
- ``cli``      the reference's executables as subcommands
"""

__version__ = "0.1.0"

from . import constants  # noqa: F401
from .device import default_dtype, resolve_device  # noqa: F401
