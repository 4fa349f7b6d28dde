from hgaprec_tpu_torch.models.state import Gam, ModelState, init_state
from hgaprec_tpu_torch.models.step import make_step

__all__ = ["Gam", "ModelState", "init_state", "make_step"]
