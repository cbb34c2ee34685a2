'''The training step's FLOPs at the window's image rate, as a share of the bf16 peak.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.train_mfu(ctx, out)
