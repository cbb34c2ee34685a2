'''The harness's frame: the manifest, the files a cell is made of, the run
context, the device checks and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``, JSON) and
a traffic mix (``portbench/traffic/<traffic>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``); ``portbench/workloads/<cell>.json``
holds the cell's correctness limits. Each per-layer metric is read by
``portbench/metrics/<metric>.py``. All are found under the checkout's root
by name. Nothing here names a cell, a model or a metric: a later cell or
metric is a set of new files and manifest entries.
'''
import dataclasses
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
# top-level module names that nothing the benchmark runs may load
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'moseq2_detectron_extract_tpu')


class SetupError(RuntimeError):
    '''The cell cannot run here (missing files, no card): no result.'''


def read_json(path: str) -> Any:
    with open(path, 'r', encoding='utf-8') as fh:
        return json.load(fh)


def load_manifest(root: str = ROOT) -> Dict:
    path = os.path.join(root, 'BENCHMARK.json')
    if not os.path.isfile(path):
        raise SetupError(f'no BENCHMARK.json in {root}')
    return read_json(path)


def find(entries: List[Dict], name: str, what: str) -> Dict:
    for entry in entries:
        if entry['name'] == name:
            return entry
    raise SetupError(f'no {what} named {name!r} in BENCHMARK.json')


def load_module(path: str, name: str):
    '''A harness file loaded by its path (names may hold dots).'''
    if not os.path.isfile(path):
        raise SetupError(f'missing {path}')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    '''Everything one cell is made of, resolved from the manifest by name.'''
    name: str
    entry: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    driver: Any
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: str

    @property
    def model_dir(self) -> str:
        path = os.path.join(self.root, self.config['model_dir'])
        if not os.path.isdir(path):
            raise SetupError(f'missing model folder {path}')
        return path


def applies(metric: Dict, cell: str, e2e_names: List[str]) -> bool:
    '''Whether ``metric`` is reported in ``cell``: by its ``workloads`` list,
    or, without one, wherever the end-to-end metric it moves is.'''
    if 'workloads' in metric:
        return cell in metric['workloads']
    if 'moves' in metric:
        return metric['moves'] in e2e_names
    return True


def resolve(name: str, root: str = ROOT) -> Cell:
    manifest = load_manifest(root)
    entry = find(manifest['workloads'], name, 'workload')
    conf = find(manifest['configs'], entry['config'], 'config')
    config = read_json(os.path.join(root, conf['file']))
    bench = os.path.join(root, 'portbench')
    traffic = read_json(os.path.join(bench, 'traffic', entry['traffic'] + '.json'))
    limits = read_json(os.path.join(bench, 'workloads', name + '.json'))
    driver = load_module(os.path.join(bench, 'drivers', traffic['driver'] + '.py'),
                         'portbench_driver_' + traffic['driver'])
    e2e = [m for m in manifest['end_to_end'] if applies(m, name, [])]
    names = [m['name'] for m in e2e]
    layer = [m for m in manifest['per_layer'] if applies(m, name, names)]
    return Cell(name, entry, config, traffic, limits, driver, e2e, layer, root)


@dataclass
class Context:
    '''What a driver gets: the cell, the run's arguments and the clock.'''
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: Any = None
    # planted faults (tests only): names the drivers know
    faults: frozenset = frozenset()
    data_dir: str = ''
    kind: str = ''


@dataclass
class Outcome:
    '''What a driver hands back.'''
    window_start: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Dict]
    observed: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None


def check(name: str, value: float, limit: float) -> Dict:
    '''One compared number beside its limit; it passes when value <= limit.'''
    return {'name': name, 'value': float(value), 'limit': float(limit),
            'ok': bool(value <= limit)}


def _as_program(value, like):
    '''A JSON value in the type the program's field holds (tuples for tuples).'''
    if isinstance(like, tuple) and isinstance(value, list):
        inner = like[0] if like else None
        return tuple(_as_program(v, inner) for v in value)
    return value


def program_config(loaded, model: Dict):
    '''The program's configuration as the configuration file states it:
    the model folder's ``config.yaml`` (``loaded``) with every key that
    the file gives otherwise set to the file's value. Returns the
    configuration and the keys it changed.'''
    changed = {}
    for f in dataclasses.fields(loaded):
        if f.name not in model:
            raise SetupError(f'model config {f.name} is missing from the configuration file')
        have = getattr(loaded, f.name)
        want = _as_program(model[f.name], have)
        if want != have:
            changed[f.name] = want
    return dataclasses.replace(loaded, **changed), sorted(changed)


def verify_config(program_cfg, model: Dict) -> None:
    '''The program's loaded configuration is the file's, key for key.'''
    for field in dataclasses.fields(program_cfg):
        key = field.name
        if key not in model:
            raise SetupError(f'model config {key} is missing from the configuration file')
        want, have = model[key], getattr(program_cfg, key)
        if isinstance(have, (list, tuple)):
            have = [list(v) if isinstance(v, (list, tuple)) else v for v in have]
        if have != want:
            raise SetupError(f'model config {key}: the program runs {have!r}, '
                             f'the configuration file states {want!r}')


class HostMeter:
    '''What the host did to this process over a stretch: its CPU seconds,
    context switches it made and suffered, and the load average, printed
    beside the window so that a slow run can be traced to the host.'''

    def __init__(self):
        import resource
        self._usage = lambda: resource.getrusage(resource.RUSAGE_SELF)
        self.start = self._usage()
        self.wall = time.perf_counter()
        self.unix = time.time()

    def read(self) -> Dict[str, float]:
        end = self._usage()
        return {'wall_s': time.perf_counter() - self.wall,
                'cpu_s': (end.ru_utime + end.ru_stime) - (self.start.ru_utime + self.start.ru_stime),
                'involuntary_switches': end.ru_nivcsw - self.start.ru_nivcsw,
                'voluntary_switches': end.ru_nvcsw - self.start.ru_nvcsw,
                'load_1min': os.getloadavg()[0], 'cores': len(os.sched_getaffinity(0)),
                'start_unix': self.unix, 'end_unix': time.time()}


def require_cards(count: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SetupError('no CUDA device: this benchmark measures the card')
    if torch.cuda.device_count() < count:
        raise SetupError(f'{torch.cuda.device_count()} CUDA devices, the cell needs {count}')


def forbidden_loaded(modules=None) -> List[str]:
    '''The forbidden top-level names among ``modules`` (default: the loaded
    ones), each compared whole: the port's name only begins with one.'''
    names = sys.modules if modules is None else modules
    return sorted({m.split('.', 1)[0] for m in names} & set(FORBIDDEN))


def read_metrics(cell: Cell, ctx: Context, out: Outcome) -> Dict[str, Dict]:
    '''Each per-layer metric's reader on the run's observations; a reader
    that finds nothing returns None and the metric is left out.'''
    values = {}
    for metric in cell.per_layer:
        reader = load_module(os.path.join(cell.root, 'portbench', 'metrics',
                                          metric['name'] + '.py'),
                             'portbench_metric_' + metric['name'].replace('.', '_'))
        value = reader.read(ctx, out)
        if value is not None:
            values[metric['name']] = {'value': float(value), 'unit': metric['unit']}
    return values


def result_line(cell: Cell, ctx: Context, out: Outcome, kind: str) -> Dict:
    checks = out.checks
    correct = bool(checks) and all(c['ok'] for c in checks)
    if ctx.trace:
        metrics = read_metrics(cell, ctx, out)
    else:
        metrics = {}
        for metric in cell.end_to_end:
            if metric['name'] == 'setup_s':
                value = out.window_start - ctx.t0
            else:
                value = out.e2e[metric['name']]
            metrics[metric['name']] = {'value': float(value), 'unit': metric['unit']}
    device = {'platform': 'gpu', 'kind': kind, 'count': int(cell.entry['chips']),
              'memory_peak_bytes': int(out.memory_peak_bytes)}
    line = {'correct': correct, 'attempted': int(out.attempted), 'failed': int(out.failed),
            'metrics': metrics, 'device': device}
    if ctx.trace and out.trace is not None:
        device['busy_s'] = out.trace.busy_s
        device['window_s'] = out.trace.window_s
        line['breakdown'] = out.trace.breakdown()
    line['checks'] = {c['name']: {'value': c['value'], 'limit': c['limit']} for c in checks}
    return line


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             faults=frozenset(), device: Optional[str] = None,
             root: str = ROOT, t0: Optional[float] = None) -> Dict:
    '''Run one cell once and return its result line. ``device`` None means
    the card, which must be there; tests pass 'cpu' to skip that look.'''
    t0 = time.perf_counter() if t0 is None else t0
    cell = resolve(name, root)
    import torch
    if device is None:
        require_cards(int(cell.entry['chips']))
        dev = torch.device('cuda', 0)
        kind = torch.cuda.get_device_name(0)
    else:
        dev = torch.device(device)
        kind = 'cpu'
    data_dir = os.path.join(root, 'portbench', 'data', name)
    ctx = Context(cell, int(seed), float(seconds), bool(trace), t0, dev, frozenset(faults),
                  data_dir, kind)
    out = cell.driver.run(ctx)
    return result_line(cell, ctx, out, kind)


def print_result(line: Dict, stream=sys.stdout) -> None:
    '''The compared numbers as the last lines on stderr, then the result as
    the last line on stdout.'''
    for name, c in line['checks'].items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), file=stream)
    stream.flush()


def phase(ctx: 'Context', name: str) -> None:
    '''Note on stderr how far set-up has come, in seconds since the start.'''
    print(f'portbench: {name} at {time.perf_counter() - ctx.t0:.3f} s', file=sys.stderr,
          flush=True)
