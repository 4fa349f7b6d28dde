"""hgaprec_tpu_torch — the PyTorch/CUDA port of hgaprec_tpu.

Hierarchical Gamma-Poisson factorization (Gopalan, Hofman & Blei,
arXiv:1311.1704) trained by CAVI on NVIDIA H100s: one, or several with
the users sharded over a torch.distributed group (`parallel/`). Module
paths follow `hgaprec_tpu/`, so each module's counterpart is found at the
same place.
Plain tensor code is PyTorch; the dense CAVI sweep runs hand-written CUDA
kernels (bf16 and f32 up to 128 packed values on the tensor cores,
`csrc/dense_wgmma.cu`; wider f32 rows `csrc/dense_simt.cu`; bound in
`ops/dense_fused.py`). The package imports torch and numpy only, never
jax.
"""

__version__ = "0.1.0"

from hgaprec_tpu_torch.config import ModelConfig, RunConfig

__all__ = ["ModelConfig", "RunConfig", "__version__"]
