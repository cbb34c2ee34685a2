'''Median device ms of the Predictor's tail at frame resolution (the
program's span ``predictor.to_frame``) a batch in the window.'''
from portbench.yardstick import spans


def read(ctx, out):
    return spans.median(out, 'predictor.to_frame', 'device_ms')
