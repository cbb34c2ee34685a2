'''Idle share of the card over traced training steps.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.idle_pct(ctx, out)
