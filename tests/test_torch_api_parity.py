'''The port's public names against the JAX package's, read with ``ast`` (no
module of either package is imported, so JAX is not).

For each module of the JAX package (one case each), every public top-level
function and class, every public method of a class and every ``__all__``
entry must have a counterpart in the port's module of the same path: a name
that module defines, assigns or imports, and for a method, a method of the port's class of that name (its
bases in the same module included). ``COUNTERPART_MODULES`` and
``COUNTERPART_NAMES`` say where the port keeps a counterpart under another
path or name. ``NO_COUNTERPART`` is the only list of exceptions, each with
its reason; an entry that is no longer missing fails too, so the list stays
exact.

Signatures are not compared. Where they differ, they differ by PyTorch's
idiom: a draw dict or a ``torch.Generator`` where a JAX function takes a
``key``, (B, K, 4) batched boxes where it takes one image's, and
``torch.distributed`` ranks where it takes a mesh's axis names.

The last cases import the port's three packages and resolve each name of
their ``__all__`` (the JAX package's lists) to the object of its module.
'''
import ast
import importlib
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = 'moseq2_detectron_extract_tpu'
PORT_PKG = 'moseq2_detectron_extract_tpu_torch'

# JAX module -> the port's module that holds its counterparts
COUNTERPART_MODULES = {
    'ops/pallas_clean.py': 'ops/clean_kernel.py',        # the CUDA kernel's module
    'ops/pallas_roi_align.py': 'ops/roi_align_kernel.py',
    'native/__init__.py': 'native.py',                   # one module: build and load
}
# 'JAX module:name' -> the port's name for it, in the module above
COUNTERPART_NAMES = {
    'ops/pallas_roi_align.py:pallas_separable_roi_align': 'roi_align',  # the kernel's wrapper
    'cli.py:cli': 'main',                       # argparse's entry point for click's group
}

_NO_TQDM = 'tqdm is absent on the card\'s machine; the port logs without it'
_NO_FFMPEG = 'no ffmpeg or cv2 on the card\'s machine; the port\'s FFV1 reader replaces them'
_FLAX = 'flax\'s; the port has nn.Module.__init__ and its flax-style init'
# 'JAX module' or 'JAX module:name' -> why the port has no counterpart
NO_COUNTERPART = {
    'io/util.py:TqdmStreamHandler': _NO_TQDM,
    'io/util.py:TqdmStreamHandler.emit': _NO_TQDM,
    'io/video.py:FFProbeInfo': _NO_FFMPEG,
    'io/video.py:has_cv2_ffmpeg': _NO_FFMPEG,
    'io/video.py:_Cv2VideoPipe.close': _NO_FFMPEG,
    'io/video.py:_Cv2VideoPipe.write_frame': _NO_FFMPEG,
    'io/video.py:_Cv2VideoPipe.wait': _NO_FFMPEG,
    'native/__init__.py:load_prep_lib': 'its counterpart is native.py:build_host_library',
    'native/__init__.py:load_kalman_lib': 'its counterpart is native.py:build_host_library',
    'utils/compile_cache.py': 'JAX\'s compilation cache; the port builds its kernels with nvcc',
    'utils/profiling.py:jax_trace': 'its counterpart is utils/profiling.py:torch_trace',
    'io/click.py': 'its counterpart is io/options.py (argparse)',
    'models/rcnn.py:MaskKeypointRCNN.setup': _FLAX,
    'models/rcnn.py:MaskKeypointRCNN.init_params': _FLAX,
    'pipeline/steps.py:FetchResultsStep.initialize': 'the port\'s step calls fetch_results',
}


def _jax_modules():
    root = os.path.join(REPO, JAX_PKG)
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith('.py'):
                yield os.path.relpath(os.path.join(dirpath, name), root).replace(os.sep, '/')


def _parse(pkg: str, rel: str):
    with open(os.path.join(REPO, pkg, rel), encoding='utf-8') as fh:
        return ast.parse(fh.read())


def _top_statements(tree):
    '''Module-level statements, those inside top-level ``if``/``try`` included.'''
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.If, ast.Try)):
            todo[:0] = node.body + node.orelse + getattr(node, 'finalbody', []) + \
                [s for h in getattr(node, 'handlers', []) for s in h.body]
            continue
        yield node


def _classes(tree):
    return {n.name: n for n in _top_statements(tree) if isinstance(n, ast.ClassDef)}


def _jax_names(tree):
    '''Public functions and classes, public methods of every class, ``__all__``.'''
    names = set()
    for node in _top_statements(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) \
                and not node.name.startswith('_'):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names |= {f'{node.name}.{m.name}' for m in node.body
                      if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                      and not m.name.startswith('_')}
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == '__all__' for t in node.targets):
            names |= {e.value for e in node.value.elts}
    return names


def _port_names(tree):
    '''Every name the module binds at the top.'''
    names = set()
    for node in _top_statements(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split('.')[0] for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                names |= {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
    return names


def _port_methods(classes, name: str):
    '''Methods and attributes of the port's class ``name``, its bases in the
    module included.'''
    node = classes.get(name)
    if node is None:
        return set()
    found = set()
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            found.add(item.name)
        elif isinstance(item, ast.Assign):
            found |= {t.id for t in item.targets if isinstance(t, ast.Name)}
    for base in node.bases:
        if isinstance(base, ast.Name) and base.id != name:
            found |= _port_methods(classes, base.id)
    return found


def missing_in_port(jax_rel: str):
    '''The JAX module's public names without a counterpart in the port.'''
    names = _jax_names(_parse(JAX_PKG, jax_rel))
    port_rel = COUNTERPART_MODULES.get(jax_rel, jax_rel)
    if not os.path.exists(os.path.join(REPO, PORT_PKG, port_rel)):
        return {jax_rel: names}
    tree = _parse(PORT_PKG, port_rel)
    bound, classes = _port_names(tree), _classes(tree)
    missing = set()
    for name in names:
        ported = COUNTERPART_NAMES.get(f'{jax_rel}:{name}', name)
        if '.' in ported:
            cls, method = ported.split('.')
            if method not in _port_methods(classes, cls):
                missing.add(name)
        elif ported not in bound:
            missing.add(name)
    return {f'{jax_rel}:{name}' for name in missing}


@pytest.mark.parametrize('jax_rel', sorted(_jax_modules()))
def test_every_public_name_has_a_counterpart(jax_rel):
    missing = missing_in_port(jax_rel)
    if isinstance(missing, dict):                       # no port module at all
        assert jax_rel in NO_COUNTERPART, (
            f'{PORT_PKG}/{COUNTERPART_MODULES.get(jax_rel, jax_rel)} is missing; '
            f'it would hold {sorted(missing[jax_rel])}')
        return
    allowed = {k for k in NO_COUNTERPART if k.startswith(jax_rel + ':')}
    assert missing - allowed == set(), f'no counterpart in the port: {sorted(missing - allowed)}'
    assert allowed - missing == set(), f'listed without counterpart but ported: ' \
                                       f'{sorted(allowed - missing)}'


def test_exceptions_name_existing_jax_names():
    modules = set(_jax_modules())
    for key, reason in NO_COUNTERPART.items():
        rel, _, name = key.partition(':')
        assert rel in modules, key
        assert reason, key
        if name:
            assert name in _jax_names(_parse(JAX_PKG, rel)), key
    for key in COUNTERPART_NAMES:
        rel, _, name = key.partition(':')
        assert name in _jax_names(_parse(JAX_PKG, rel)), key


def _jax_all(rel: str):
    for node in _parse(JAX_PKG, rel).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == '__all__' for t in node.targets):
            return [e.value for e in node.value.elts]
    return []


@pytest.mark.parametrize('package', ['ops', 'models', 'pipeline'])
def test_package_exports_resolve(package):
    '''``from <port>.<package> import <name>`` for each name of the JAX
    package's ``__all__``, which is the object its module defines.'''
    jax_all = _jax_all(f'{package}/__init__.py')
    port = importlib.import_module(f'{PORT_PKG}.{package}')
    assert sorted(port.__all__) == sorted(jax_all)
    for name in jax_all:
        value = getattr(port, name)
        assert value.__module__.startswith(f'{PORT_PKG}.{package}.'), name
        assert value is getattr(importlib.import_module(value.__module__), name), name
    with pytest.raises(AttributeError):
        getattr(port, 'not_exported')


def test_aliases_and_annotation_types():
    '''``FrozenBatchNorm`` is the port's ``FrozenBatchNorm2d``; the annotation
    ``TypedDict``s have the JAX package's fields (read from its source).'''
    from moseq2_detectron_extract_tpu_torch.io import annot
    from moseq2_detectron_extract_tpu_torch.models import layers, resnet
    assert resnet.FrozenBatchNorm is layers.FrozenBatchNorm2d
    classes = _classes(_parse(JAX_PKG, 'io/annot.py'))
    for name in ('SegmAnnotation', 'KptSegmAnnotation', 'DataItem'):
        fields = {n.target.id for n in classes[name].body if isinstance(n, ast.AnnAssign)}
        for base in classes[name].bases:
            if isinstance(base, ast.Name) and base.id in classes:
                fields |= {n.target.id for n in classes[base.id].body
                           if isinstance(n, ast.AnnAssign)}
        assert set(getattr(annot, name).__annotations__) == fields, name
    assert set(annot.MaskFormat.__args__) == {'polygon', 'bitmask'}
