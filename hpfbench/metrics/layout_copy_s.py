"""layout_copy_s (s): host seconds of the layout build's host-to-device
copies, the port's `layout.copy` spans (the COO's fields, the tail's, and
the head's scatter indexes; `hgaprec_tpu_torch/trace.py`)."""

from hpfbench import spans


def read(ctx: dict):
    return spans.seconds("layout.copy")
