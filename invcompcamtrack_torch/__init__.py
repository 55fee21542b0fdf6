"""invcompcamtrack_torch — the PyTorch/CUDA port of invcompcamtrack_tpu.

The JAX package beside it is the reference: every module here mirrors
the JAX module of the same name (``core/lie.py`` <-> ``core/lie.py``)
and is held against it by the ``tests/test_torch_*.py`` suite.  The
Pallas TPU kernels of the tracker's hot loop are hand-written CUDA
kernels for Hopper (``csrc/``), each with a plain PyTorch version in the
same module; a CPU tensor takes the plain version, a CUDA tensor the
kernel.

Precision: the JAX package contracts at ``Precision.HIGHEST``.  The
port therefore keeps TF32 off for float32 matrix products and
convolutions on the card; importing the package sets both flags.

This package imports ``torch`` and never ``jax``, and nothing of the JAX
package: ``config.py``, ``vo/{synthetic,datasets}.py`` and
``utils/{io,image,viz,metrics,rotation,splines,sensors,plot3d,native}.py``
are its own copies of the JAX package's jax-free modules.  ``ICGNParams``
and ``synthetic`` are re-exported here.

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.py``).
"""

import torch

from invcompcamtrack_torch.config import ICGNParams  # noqa: F401
from invcompcamtrack_torch.vo import synthetic  # noqa: F401

__version__ = "0.2.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
