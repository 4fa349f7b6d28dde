"""Configuration for models and runs (PyTorch port).

Counterpart of `hgaprec_tpu/config.py`. The same two objects:

  * ModelConfig — static model description (variant, priors, precision).
  * RunConfig   — host-side operational knobs (dirs, cadence, seeds) and
                  the reference's output-directory naming contract.

`derive_outdir` is byte-identical to the JAX package's, so both write to
the same directory for the same flags.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

# Execution paths for the phi sweep (hot loop). On a CUDA tensor the two
# segment modes are one request: the CSR sweep kernel over the COO.
SWEEP_DENSE = "dense"      # blocked dense sweep over a uint8 count matrix
SWEEP_DENSE_PALLAS = "dense-pallas"  # name kept: the fused-kernel request
SWEEP_SEGMENT = "segment"  # sweep over the dual-sorted COO
SWEEP_SEGMENT_CHUNKED = "segment-chunked"  # the same, streamed over chunks
SWEEP_HYBRID = "hybrid"    # dense head (top-degree items) + sparse tail
SWEEP_AUTO = "auto"

VARIANT_BPF = "bpf"            # vb()        hgaprec.cc:919-980
VARIANT_HPF = "hpf"            # vb_hier()   hgaprec.cc:1321-1436
VARIANT_MLE_USER = "mle_user"  # vb_mle_user hgaprec.cc:982-1056
VARIANT_MLE_ITEM = "mle_item"  # vb_mle_item hgaprec.cc:1059-1130
VARIANT_CANNY = "canny"        # vb_canny    hgaprec.cc:1132-1216

_VARIANTS = (VARIANT_BPF, VARIANT_HPF, VARIANT_MLE_USER, VARIANT_MLE_ITEM,
             VARIANT_CANNY)
_PRECISIONS = ("highest", "default")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model description.

    Tail precision policy (hybrid sweep): the tail follows
    `matmul_precision` like the head. "default" rounds the
    bias-augmented factor tables to bf16 once and computes dots, weights
    and sums in f32; "highest" keeps f32 tables, so it is true f32 end
    to end. This departs from the reference, whose TPU tail runs bf16
    tables even under "highest" (hgaprec_tpu/ops/sweep.py:316-323).
    """

    n: int                    # users
    m: int                    # items
    k: int                    # latent factors
    variant: str = VARIANT_BPF
    bias: bool = False        # user/item bias terms (-bias), phi gets K+2 slots
    binary: bool = False      # Bernoulli-Poisson link (-binary-data)
    vb: bool = True           # staggered swap order; False = -novb (synchronous)
    # Gamma priors. Reference effective values are all 0.3 (hgaprec.cc:13-20).
    a: float = 0.3            # theta shape prior
    b: float = 0.3            # theta rate prior
    c: float = 0.3            # beta shape prior
    d: float = 0.3            # beta rate prior
    ap: float = 0.3           # xi (user activity) shape prior
    bp: float = 0.3           # xi rate prior
    cp: float = 0.3           # eta (item popularity) shape prior
    dp: float = 0.3           # eta rate prior
    dtype: str = "float32"
    # Sweep/scoring product precision. "highest": true f32 (TF32 off);
    # "default": bf16 inputs with f32 accumulation in the sweep kernel.
    matmul_precision: str = "highest"
    sweep: str = SWEEP_AUTO
    # Hybrid-mode tail implementation. Only "auto" exists: the tail kernel
    # (ops/tail_fused.py) on a CUDA tensor, its plain version on a CPU
    # tensor. The JAX values "pallas"/"mxu" name TPU implementations.
    tail_impl: str = "auto"
    # Plain dense path: block sizes for streaming the [N, M] products.
    item_block: int = 4096
    user_block: int = 8192
    # Data layout at Trainer build time: catalogs whose uint8 count
    # matrix exceeds dense_limit_bytes get the hybrid head/tail layout
    # with up to hybrid_head_items top-degree items in the dense head
    # block, clipped to a head_limit_bytes byte budget (the JAX meaning
    # and defaults, hgaprec_tpu/config.py:78-92).
    hybrid_head_items: int = 8192
    dense_limit_bytes: int = 10 << 30
    head_limit_bytes: int = 4 << 30

    def __post_init__(self):
        if self.variant not in _VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.tail_impl != "auto":
            raise ValueError(f"unknown tail_impl {self.tail_impl!r} (auto)")
        if self.matmul_precision not in _PRECISIONS:
            raise ValueError(f"unknown matmul_precision "
                             f"{self.matmul_precision!r} (highest|default)")
        if self.bias and self.variant in (VARIANT_MLE_USER, VARIANT_MLE_ITEM,
                                          VARIANT_CANNY):
            # reference asserts this combination away (hgaprec.cc:1505)
            raise ValueError("bias is not supported with MLE/Canny variants")

    @property
    def hier(self) -> bool:
        return self.variant == VARIANT_HPF

    @property
    def mle(self) -> bool:
        return self.variant in (VARIANT_MLE_USER, VARIANT_MLE_ITEM,
                                VARIANT_CANNY)

    def resolve_sweep(self) -> str:
        if self.sweep != SWEEP_AUTO:
            return self.sweep
        return SWEEP_DENSE if self.m <= 65536 else SWEEP_SEGMENT


def set_matmul_precision(precision: str) -> None:
    """Pin PyTorch's f32 product mode to the configured meaning.

    "highest" must be true f32 on the card, so TF32 is switched off
    explicitly for both matmuls and cuDNN. "default" changes nothing
    here: its bf16 inputs are cast inside the sweep kernel."""
    import torch
    if precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class RunConfig:
    """Operational knobs (reference Env fields + output-dir contract)."""

    datdir: str = "."                 # -dir: train/test/validation tsv location
    outdir: Optional[str] = None      # override; default derives like env.hh:283-369
    label: str = ""                   # -label
    rfreq: int = 10                   # -rfreq: report cadence
    max_iterations: int = 1000        # -max-iterations (honored by hier; parity)
    seed: int = 0                     # -seed
    rating_threshold: int = 1         # -rating-threshold
    logl: bool = False                # -logl: training ELBO each report
    batch: bool = True
    enforce_max_iterations: bool = False  # reference: only vb_hier checks it
    num_precision_users: int = 1000   # sampled users per precision report (hgaprec.cc:1715)
    topn_by_user: int = 100           # _topN_by_user (hgaprec.cc:30)
    write_marginals: bool = True
    # when set, training runs under torch.profiler with a TensorBoard
    # trace handler writing into this directory (-trace DIR)
    trace_dir: Optional[str] = None
    # bridge-mode flags — only used for output-dir naming parity
    # (env.hh:326-369); the dispatch lives in the CLI
    nmf: bool = False                 # -nmf or -nmfload
    lda: bool = False
    vwlda: bool = False
    chi: bool = False
    ctr: bool = False
    write_training: bool = False
    chi_tool: str = ""                # "nmf" | "als" | "wals" | "climf"
    wals_l: float = 0.1
    wals_C: int = 10

    def derive_outdir(self, mc: ModelConfig) -> str:
        """Reference output-dir naming (env.hh:283-369) for supported flags."""
        parts = [f"n{mc.n}-m{mc.m}-k{mc.k}"]
        if self.label:
            parts.append(self.label)
        else:
            base = os.path.basename(os.path.normpath(self.datdir))
            q = base[:2]
            if len(base) > 3 and q[:1].isalpha():
                parts.append(q)
        for nm, v in (("a", mc.a), ("b", mc.b), ("c", mc.c), ("d", mc.d)):
            if v != 0.3:
                parts.append(f"{nm}{v:g}")
        parts.append("batch" if self.batch else "online")
        if mc.binary:
            parts.append("bin")
        if mc.bias:
            parts.append("bias")
        if mc.hier:
            parts.append("hier")
        if mc.vb:
            parts.append("vb")
        # bridge suffixes in reference order (env.hh:326-369)
        if self.nmf:
            parts.append("nmf")
        if self.lda:
            parts.append("lda")
        if self.vwlda:
            parts.append("vwlda")
        if self.chi:
            parts.append("chi")
        if self.ctr:
            parts.append("ctr")
        if self.seed:
            parts.append(f"seed{self.seed:g}")
        if self.write_training:
            parts.append("write-training")
        if self.chi:
            if self.chi_tool == "nmf":
                parts.append("nmf")
            elif self.chi_tool == "als":
                parts.append("als")
            elif self.chi_tool == "wals":
                parts.append(f"wals-wl-{self.wals_l:g}-wC-{self.wals_C}")
            elif self.chi_tool == "climf":
                parts.append("climf")
        if mc.variant == VARIANT_MLE_USER:
            parts.append("mle-user")
        elif mc.variant == VARIANT_MLE_ITEM:
            parts.append("mle-item")
        elif mc.variant == VARIANT_CANNY:
            parts.append("canny")
        return "-".join(parts)

    def resolve_outdir(self, mc: ModelConfig) -> str:
        return self.outdir if self.outdir else self.derive_outdir(mc)
