'''Idle share of the card over a traced chunk of the inference cell.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.idle_pct(ctx, out)
