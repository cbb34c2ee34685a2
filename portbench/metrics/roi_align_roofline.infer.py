'''ROIAlign kernel: the bytes bound over its device time in a traced chunk.'''
from portbench.yardstick import readers


def read(ctx, out):
    return readers.roofline_pct(ctx, out, 'roi_align_kernel', 'roi_bytes')
