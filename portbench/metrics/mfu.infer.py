'''The detector's FLOPs at the window's frame rate, as a share of the bf16 peak.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.inference_mfu(ctx, out)
