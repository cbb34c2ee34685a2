'''Host ms a training step waits for its batch (the program's span
``train.wait_batch``), the window's total over its steps (``train.step``).'''
from portbench.yardstick import spans


def read(ctx, out):
    return spans.total_per(out, 'train.wait_batch', 'host_ms', 'train.step')
