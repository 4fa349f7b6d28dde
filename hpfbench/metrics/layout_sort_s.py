"""layout_sort_s (s): host seconds of the layout build's sorts, the port's
`layout.sort` spans (the top-degree items' argsort, the tail's stable
argsort, the COO's lexsort; `hgaprec_tpu_torch/trace.py`)."""

from hpfbench import spans


def read(ctx: dict):
    return spans.seconds("layout.sort")
