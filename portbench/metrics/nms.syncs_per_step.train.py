'''Host syncs of the train proposal NMS per training step in the window.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.per(out, 'nms_syncs', 'steps')
