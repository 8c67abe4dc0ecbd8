"""PyTorch/CUDA port of the gradient-boosting container.

The package mirrors ``sagemaker_xgboost_container_tpu``'s module paths and
function names, so every function here has a counterpart of the same name
there. It imports ``torch`` and numpy only. Its entry points (``train``,
``Forest.predict``) run on CUDA unless the caller passes ``device="cpu"``;
they raise when no GPU is present rather than falling back to the CPU.

The two histogram kernels of the tree builder are hand-written CUDA
(``csrc/``), built at first use by ``_build.py``.
"""

# the JAX package's version: a manifest's config fingerprint carries it, and
# one release of the container is one version in both packages
__version__ = "0.1.0"

from .models.booster import train  # noqa: F401,E402
from .models.forest import Forest  # noqa: F401,E402
