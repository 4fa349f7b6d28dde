"""pair_gb (GB): bytes per iteration through the item pass's pair buffer,
which the pass writes once and reads back once: 2 x the port's
`slabs.pair_bytes` note (the last slab stream built, `ops/segment_fused.py
::slab_stream`) / 1e9. The rooflines' least bytes leave the buffer out,
so this is where writing fewer pair rows shows. None where the note is
absent: no slab stream (the bf16 tail), or a program that notes none."""

from hpfbench import spans


def read(ctx: dict):
    got = spans.notes().get("slabs.pair_bytes")
    return None if got is None else 2 * got / 1e9
