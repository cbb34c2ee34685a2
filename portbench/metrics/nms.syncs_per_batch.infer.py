'''Host syncs of the proposal NMS per Predictor batch in the window.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.per(out, 'nms_syncs', 'batches')
