"""hgaprec_tpu_torch — the PyTorch/CUDA port of hgaprec_tpu.

Hierarchical Gamma-Poisson factorization (Gopalan, Hofman & Blei,
arXiv:1311.1704) trained by CAVI on NVIDIA H100s: one, or several with
the users sharded over a torch.distributed group (`parallel/`). Module
paths follow `hgaprec_tpu/`, so each module's counterpart is found at the
same place.
Plain tensor code is PyTorch; the dense CAVI sweep runs hand-written CUDA
kernels on the tensor cores, all in `csrc/dense_wgmma.cu` (bf16 up to 256
packed values and f32 up to 128; wider rows the resident wide kernel, f32
up to 320 values and bf16 up to 384, then the streamed one; bound in
`ops/dense_fused.py`). The package imports torch and numpy only, never
jax.
"""

__version__ = "0.1.0"

from hgaprec_tpu_torch.config import ModelConfig, RunConfig

__all__ = ["ModelConfig", "RunConfig", "__version__"]
