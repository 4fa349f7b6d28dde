"""Both packages' native TSV writers, loaded in this test process.

The JAX package builds its library in place (`g++ -o` straight onto
`.native_build/libfastload.so`, hgaprec_tpu/data/native.py). A test worker
that loads it while another worker's g++ is still writing it fails, and
the module keeps that failure for the life of the process (`_tried`), so
`_save_mat` takes its Python path for good. That path formats the values
as it is given them: the float64 factors of `-nmfload` and `-ctr` come
out at %.8f of the float64 value, where the native writers (both
packages') and the port's Python path write the float32 value. The
files then differ in nearly every value. `load_both` loads again until
the other worker's build has finished.
"""

import time
from typing import List

from hgaprec_tpu.data import native as j_native
from hgaprec_tpu_torch.data import native as t_native

WRITERS = (("the JAX package's native TSV writer "
            "(hgaprec_tpu/data/native.py)", j_native),
           ("the port's native TSV writer "
            "(hgaprec_tpu_torch/data/native.py)", t_native))


def load_both(deadline_s: float = 120.0) -> List[str]:
    """Load both native writers, retrying a load that failed (while
    another process built the library) every half second until
    `deadline_s` has passed. Returns the names of those that still did
    not load."""
    t_end = time.monotonic() + deadline_s
    while True:
        missing = []
        for name, mod in WRITERS:
            if mod._load() is None:
                mod._tried = False      # let the next _load() try again
                missing.append(name)
        if not missing or time.monotonic() > t_end:
            return missing
        time.sleep(0.5)
