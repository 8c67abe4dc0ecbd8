"""PyTorch/CUDA port of the gradient-boosting container.

The package mirrors ``sagemaker_xgboost_container_tpu``'s module paths and
function names, so every function here has a counterpart of the same name
there. It imports ``torch`` and numpy only. Its entry points (``train``,
``Forest.predict``) run on CUDA unless the caller passes ``device="cpu"``;
they raise when no GPU is present rather than falling back to the CPU.

The two histogram kernels of the tree builder are hand-written CUDA
(``csrc/``), built at first use by ``_build.py``.
"""

from .models.booster import train  # noqa: F401
from .models.forest import Forest  # noqa: F401
