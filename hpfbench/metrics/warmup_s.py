"""warmup_s (s): host seconds of the multi-step's first call before its
first replay, the port's `multistep.warmup` (the eager step, which builds
the slab streams on the card) and `multistep.capture` spans (the capture
begins with a synchronize, so the warm-up's device work ends inside);
none where the steps run in a loop and neither is recorded."""

from hpfbench import spans


def read(ctx: dict):
    return spans.seconds("multistep.warmup", "multistep.capture")
