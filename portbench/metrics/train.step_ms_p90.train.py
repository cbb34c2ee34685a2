'''The 90th percentile of the host ms of the window's training steps (the
program's span ``train.step``).'''
from portbench.yardstick import spans


def read(ctx, out):
    return spans.p90(out, 'train.step', 'host_ms')
