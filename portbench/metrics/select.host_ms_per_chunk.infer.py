'''Median host ms of the instance selection's host tracker and window
origins (the program's span ``chunk.select.track``) a chunk in the window.'''
from portbench.yardstick import spans


def read(ctx, out):
    return spans.median(out, 'chunk.select.track', 'host_ms')
