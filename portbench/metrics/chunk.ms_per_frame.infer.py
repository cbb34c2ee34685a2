'''Median wall time of a window chunk per frame.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.chunk_ms_per_frame(ctx, out)
