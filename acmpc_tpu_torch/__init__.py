"""PyTorch/CUDA port of the acmpc_tpu MPC control step.

The JAX package ``acmpc_tpu`` is the reference; this package mirrors its
module paths (``geometry/path.py``, ``qp/admm.py``, ...) so each
counterpart is easy to find, and never imports it or JAX. The fused ADMM
iteration chunk runs as a hand-written CUDA kernel
(``csrc/admm_chunk.cu``, bound in ``ops/admm_chunk.py``).

Precision is fp32 throughout. The ADMM engine chases 1e-3 residuals and
TF32 (10-bit mantissa) products break that target, so TF32 is switched
off for both cuBLAS and cuDNN here, once, at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if torch.get_float32_matmul_precision() != "highest":
    raise RuntimeError(
        "acmpc_tpu_torch needs full-fp32 matmuls; "
        f"float32 matmul precision is {torch.get_float32_matmul_precision()!r}"
    )
