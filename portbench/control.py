'''Run a cell with its control in the program's place: the plain reference
computed one precision below the configuration's (float8 e4m3 for a bf16
model), judged by the cell's own checks. The control has to come out not
correct; its numbers are the upper readings the limits are set below.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 --seconds <s>

Prints one JSON line per seed with the compared numbers.
'''
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    from portbench import core
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=5.0)
    p.add_argument('--fault', default='control',
                   help='the planted fault to run in place of the program')
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        line = core.run_cell(args.workload, seed, args.seconds, False, faults={args.fault})
        print(json.dumps({'seed': seed, 'fault': args.fault, 'correct': line['correct'],
                          'checks': line['checks'], 'seconds': time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
