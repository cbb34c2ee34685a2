'''Median device ms of the proposal NMS (the program's span
``detector.proposal_nms``) a Predictor batch in the window.'''
from portbench.yardstick import spans


def read(ctx, out):
    return spans.median(out, 'detector.proposal_nms', 'device_ms')
