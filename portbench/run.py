'''Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics. Exits 2 without a
result when the cell's files or the card are missing, and 3 when a module
of JAX or of the JAX package was loaded.
'''
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root: the harness as a package, the program beside it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a library the port uses must not load JAX on its own
os.environ.setdefault('USE_FLAX', '0')
os.environ.setdefault('USE_JAX', '0')


def main(argv=None) -> int:
    from portbench import core
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        line = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    except core.SetupError as exc:
        print(f'portbench: {exc}', file=sys.stderr)
        return 2
    loaded = core.forbidden_loaded()
    if loaded:
        print(f'portbench: forbidden modules loaded: {", ".join(loaded)}', file=sys.stderr)
        return 3
    core.print_result(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
