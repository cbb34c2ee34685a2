'''CPU ms of the trainer's thread a training step: the window's total over
its steps (the program's span ``train.step``, ``time.thread_time``). A
total, not a median: the thread's CPU clock may tick as coarsely as 10 ms
(it does on the card's machine), and the median of ticked steps moves in
whole ticks while their sum does not.'''
from portbench.yardstick import spans


def read(ctx, out):
    return spans.total_per(out, 'train.step', 'cpu_ms', 'train.step')
