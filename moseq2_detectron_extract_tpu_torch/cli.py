'''The command line of the port: the model lifecycle around ``extract``.

    python -m moseq2_detectron_extract_tpu_torch.cli extract <depth.dat> \
        --model benchmarks/bench_model_fast160 [--device cpu] [--output-dir DIR]
    python -m moseq2_detectron_extract_tpu_torch.cli convert-weights <zoo.pkl> \
        --model-dir DIR [--config YAML]
    python -m moseq2_detectron_extract_tpu_torch.cli train <export.json> \
        --model-dir DIR [--config YAML] [--max-iter N] [--resume] \
        [--init-weights <zoo.pkl>] [--device cpu]
    python -m moseq2_detectron_extract_tpu_torch.cli evaluate <export.json> --model-dir DIR
    python -m moseq2_detectron_extract_tpu_torch.cli compile-model [<export.json>] \
        --model-dir DIR [--output DIR] [--batch-size 10]
    python -m moseq2_detectron_extract_tpu_torch.cli infer-dataset <tasks.json> --model-dir DIR
    python -m moseq2_detectron_extract_tpu_torch.cli find-roi <depth.dat> [--output-dir DIR]
    python -m moseq2_detectron_extract_tpu_torch.cli convert-raw-to-avi <depth.dat> \
        [-o depth.avi] [-b 3000] [--fps 30] [--delete] [-t 3]
    python -m moseq2_detectron_extract_tpu_torch.cli visualize-raw <depth.dat> [-o preview.avi]
    python -m moseq2_detectron_extract_tpu_torch.cli visualize-result <results_00.h5> \
        [-o results_00.preview.avi]
    python -m moseq2_detectron_extract_tpu_torch.cli find-outliers <results_00.h5> \
        [--window 4] [--threshold 10]
    python -m moseq2_detectron_extract_tpu_torch.cli trim-result <results_00.h5> \
        --start N --stop M [--no-backup]
    python -m moseq2_detectron_extract_tpu_torch.cli manual-flip <results_00.h5> <flips.txt> \
        [--no-backup]
    python -m moseq2_detectron_extract_tpu_torch.cli verify-flips <flips.txt>... [--max-frames N]
    python -m moseq2_detectron_extract_tpu_torch.cli generate-dataset <depth.dat>... \
        --output-dir DIR [--num-samples 100] [--sample-method random|uniform|kmeans|list] \
        [--frame-indices 1,2,3]
    python -m moseq2_detectron_extract_tpu_torch.cli dataset-info <export.json>...
    python -m moseq2_detectron_extract_tpu_torch.cli generate-extract-config \
        [-o extract-config.yaml]
    python -m moseq2_detectron_extract_tpu_torch.cli extract-batch <dir> --model M \
        [--config-file C] [--extension .dat] [--cluster-type local|slurm] \
        [--in-process [--max-concurrent N] [--device cpu]]
    python -m moseq2_detectron_extract_tpu_torch.cli system-info

Port of ``moseq2_detectron_extract_tpu/cli.py`` on ``argparse`` (the card's
machine has no click): the same option names, defaults and help strings.
``--device`` (default ``cuda``) is the port's own on every command that
runs a model or the ROI search.

``extract`` is ``cli.py:37-129``: ``--config-file`` as
``io/click.py:command_with_config`` gives it, the ``allowed_detections``
rule, and the config keys ``use_tracking_model``, ``flip_classifier``,
``dataset_name`` and ``param_annotations``. ``--report-outliers`` searches
the finished results for outlier frames (``quality.py``), as ``find-outliers``
does; ``--device-input prescaled`` resizes each chunk to the model's canvas
on the host and uploads that and the detections' windows
(``pipeline/steps.py:run_inference_prescaled``).

``train`` is ``cli.py:131-166`` (``--log-period``, the metrics' period,
20 as in the JAX trainer, is the port's own); ``convert-weights``,
``evaluate``, ``compile-model``, ``infer-dataset`` and ``find-roi`` are
``cli.py:169-321``. ``compile-model`` writes a ``torch.export`` program,
``model.pt2``, in place of ``model.hlo`` (``models/deploy.py``).
Every session command takes a raw ``depth.dat`` or an FFV1 ``depth.avi``
(``io/video.py``); ``convert-raw-to-avi`` (``cli.py:323-360``) writes the
latter with the port's own encoder (``io/ffv1.py``) and reads every chunk
back, bit for bit, before ``--delete`` removes the raw file.
``generate-dataset`` is ``cli.py:401-430`` (its k-means is
``proc/kmeans.py``; ``--with-rgb`` writes depth images only).
``visualize-raw`` and ``visualize-result`` are ``cli.py:362-394``; they
write Motion-JPEG AVIs (``preview.avi``, ``<results>.preview.avi``) where
the reference writes ``.mp4`` (``viz.py``).

The result upkeep is ``cli.py:431-530``: ``dataset-info``, ``find-outliers``,
``manual-flip``, ``verify-flips`` (exit code 1 on a bad flips file),
``trim-result`` and ``generate-extract-config`` (the extract defaults, with
the port's ``device``). ``manual-flip`` and ``trim-result`` copy the file to
``<result>.bak`` first unless ``--no-backup``, then write the edited file
anew beside it and rename it onto the old one (``io/hdf5.py:rewrite``).
``system-info`` (``cli.py:606-632``) prints torch, CUDA and cuDNN in place
of jax and flax, and the CUDA devices, or says there is none.
``extract-batch`` (``cli.py:533-603``) prints a ``python -m
moseq2_detectron_extract_tpu_torch.cli extract ...`` command per unextracted
session where the reference prints ``moseq2-detectron-extract-tpu extract
...``; with ``--in-process`` it extracts them on this machine's CUDA
devices (``parallel/sessions.py``) and exits 1 when a session failed.

``main`` returns the command's exit code. With ``MOSEQ_DETECTRON_PROFILE``
set, it profiles the process (``utils/profiling.py``; the files are written
at exit), as the reference's group does. The reference's group also turns
on JAX's compilation cache (``utils/compile_cache.py``); the port has no
counterpart, since PyTorch compiles nothing there, and its CUDA kernels are
built once per source into ``_build/`` (``native.py``).
'''
import argparse
import logging
import os
import sys
from typing import List, Optional, Sequence

from moseq2_detectron_extract_tpu_torch.io.options import (apply_config_file, click_bool,
                                                           click_param_annot, float_range,
                                                           int_range, optional)
from moseq2_detectron_extract_tpu_torch.io.util import setup_logging


def _pair(convert):
    return {'nargs': 2, 'type': convert}


def _existing(path: str) -> str:
    if not os.path.exists(path):
        raise argparse.ArgumentTypeError(f'path {path!r} does not exist')
    return path


def _existing_dir(path: str) -> str:
    if not os.path.isdir(_existing(path)):
        raise argparse.ArgumentTypeError(f'{path!r} is not a directory')
    return path


def _existing_file(path: str) -> str:
    if not os.path.isfile(_existing(path)):
        raise argparse.ArgumentTypeError(f'{path!r} is a directory')
    return path


def _add_bg_roi_options(p: argparse.ArgumentParser) -> None:
    '''The ROI search's options, shared by ``extract`` and ``find-roi``.'''
    p.add_argument('--bg-roi-dilate', default=(10, 10), **_pair(int), help='Size of the mask dilation (to include environment walls)')
    p.add_argument('--bg-roi-shape', default='ellipse', type=str, help='Shape to use for the mask dilation (ellipse or rect)')
    p.add_argument('--bg-roi-index', default=0, type=int, help='Index of which background mask(s) to use')
    p.add_argument('--bg-roi-weights', default=(1, .1, 1), nargs=3, type=float, help='Feature weighting (area, extent, dist) of the background mask')
    p.add_argument('--bg-roi-depth-range', default=(650, 750), **_pair(float), help='Range to search for floor of arena (in mm)')
    p.add_argument('--bg-roi-gradient-filter', default=False, type=click_bool, help='Exclude walls with gradient filtering')
    p.add_argument('--bg-roi-gradient-threshold', default=3000, type=float, help='Gradient must be < this to include points')
    p.add_argument('--bg-roi-gradient-kernel', default=7, type=int, help='Kernel size for Sobel gradient filtering')
    p.add_argument('--bg-roi-fill-holes', default=True, type=click_bool, help='Fill holes in ROI')
    p.add_argument('--use-plane-bground', action='store_true', help='Use a plane fit for the background')


def _typed_defaults(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    '''Pass each default through its option's type, as click passes a
    default as a given value: (650, 750) of a float pair is (650.0, 750.0).'''
    for action in p._actions:
        if action.type is not None and action.default is not None \
                and not isinstance(action.default, str):
            action.default = tuple(map(action.type, action.default)) \
                if isinstance(action.default, tuple) else action.type(action.default)
    return p


def _replace_pairs(replace_paths):
    '''``--replace-paths`` search:replace strings -> (search, replace) pairs.'''
    return [tuple(rp.split(':', 1)) for rp in replace_paths] if replace_paths else None


def extract_parser() -> argparse.ArgumentParser:
    '''The ``extract`` command's options, in the reference's order.'''
    p = argparse.ArgumentParser(prog='extract', description='Extract a moseq session raw data',
                                allow_abbrev=False)
    p.add_argument('input_file', metavar='INPUT_FILE', type=_existing_file)
    p.add_argument('--model', default=None, type=_existing, help='Path to the model for inference.')
    p.add_argument('--checkpoint', default='last', help='Model checkpoint to load. Use "last" to load the last checkpoint')
    p.add_argument('--batch-size', default=10, type=int, help='Number of frames for each model inference iteration')
    p.add_argument('--instance-threshold', default=0.5, type=float_range(0.0, 1.0), help='Minimum score threshold to filter inference results')
    p.add_argument('--expected-instances', default=1, type=int_range(min=1), help='Maximum number of instances expected in each frame')
    p.add_argument('--allowed-detections', default=None, type=optional(int_range(min=1)), help='Maximum number of detections reported by the detector')
    _add_bg_roi_options(p)
    p.add_argument('--output-dir', default=None, help='Output directory to save the extraction output files')
    p.add_argument('--frame-dtype', default='uint8', choices=['uint8', 'uint16'], help='Data type for processed frames')
    p.add_argument('--min-height', default=0, type=int, help='Min mouse height from floor (mm)')
    p.add_argument('--max-height', default=100, type=int, help='Max mouse height from floor (mm)')
    p.add_argument('--crop-size', default=(80, 80), **_pair(int), help='Size of crop region')
    p.add_argument('--report-outliers', action='store_true', help='Report outliers in extracted data')
    p.add_argument('--frame-trim', default=(0, 0), **_pair(int), help='Frames to trim from beginning and end of data')
    p.add_argument('--chunk-size', default=1000, type=int, help='Number of frames for each processing iteration')
    p.add_argument('--chunk-overlap', default=0, type=int, help='Frames overlapped in each chunk')
    p.add_argument('--fps', default=30, type=int, help='Frame rate of camera')
    p.add_argument('--use-tracking', '--no-use-tracking', dest='use_tracking', default=True,
                   action=_OnOff, nargs=0, help='during feature processing, use tracking models')
    p.add_argument('--debug-feature-processing', action='store_true', help='Generate additional reports of internal data during feature processing')
    p.add_argument('--device-input', default='full', choices=['full', 'prescaled'],
                   help='Upload full-res frames and resize on device (full), or '
                        'resize to the model canvas on host and upload that plus '
                        'per-detection windows (prescaled; ~3x fewer bytes over '
                        'a thin host<->device link)')
    p.add_argument('--config-file', default=None)
    p.add_argument('--device', default='cuda',
                   help='Device that runs the model and the device path (cuda, or cpu)')
    return _typed_defaults(p)


class _OnOff(argparse.Action):
    '''``--flag`` sets True and ``--no-flag`` False (click's ``--a/--no-a``).'''

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, not option_string.startswith('--no-'))


def extract(argv: Sequence[str]) -> str:
    '''Run the ``extract`` command; returns the status YAML's path.'''
    parser = extract_parser()
    args = parser.parse_args(list(argv))
    apply_config_file(parser, args, argv)
    for key in ('bg_roi_dilate', 'bg_roi_weights', 'bg_roi_depth_range', 'crop_size',
                'frame_trim'):
        if isinstance(getattr(args, key), list):
            setattr(args, key, tuple(getattr(args, key)))

    from moseq2_detectron_extract_tpu_torch.extract import extract_session
    from moseq2_detectron_extract_tpu_torch.io.session import Session

    setup_logging(add_defered_file_handler=True)
    print('')
    if args.allowed_detections is None or args.allowed_detections < args.expected_instances:
        args.allowed_detections = (args.expected_instances + 1) * 2
        logging.info('WARNING: --allowed-detections was not set or less than '
                     '--expected-instances, will set --allowed-detections to %d',
                     args.allowed_detections)

    config_data = dict(vars(args))
    config_data.update({
        'use_tracking_model': False,
        'flip_classifier': args.model,
        'dataset_name': 'moseq',
        'param_annotations': click_param_annot(parser),
    })
    session = Session(args.input_file, frame_trim=args.frame_trim)
    status_filename = extract_session(session=session, config=config_data)

    if args.report_outliers:
        from moseq2_detectron_extract_tpu_torch.proc.keypoints import default_keypoint_names
        from moseq2_detectron_extract_tpu_torch.proc.util import check_completion_status
        from moseq2_detectron_extract_tpu_torch.quality import find_outliers_h5
        logging.info('')
        if not check_completion_status(status_filename):
            logging.info('Skipping search for outlier frames because session '
                         'extraction was not completed!')
        else:
            logging.info('Searching for outlier frames....')
            find_outliers_h5(os.path.splitext(status_filename)[0] + '.h5',
                             keypoint_names=[kp for kp in default_keypoint_names
                                             if kp != 'TailTip'])
    return status_filename


def train_parser() -> argparse.ArgumentParser:
    '''The ``train`` command's options.'''
    p = argparse.ArgumentParser(prog='train', description='Train a model on annotated data',
                                allow_abbrev=False)
    p.add_argument('annot_files', metavar='ANNOT_FILES', nargs='*', type=_existing)
    p.add_argument('--model-dir', required=True, help='Directory to store model outputs')
    p.add_argument('--resume', action='store_true', help='Resume training from the latest checkpoint')
    p.add_argument('--config', dest='config_yaml', default=None, type=_existing, help='Model config yaml to merge over base config')
    p.add_argument('--max-iter', default=None, type=optional(int), help='Override number of training iterations')
    p.add_argument('--replace-paths', default=None, action='append', help='search:replace pairs for fixing annotation image paths')
    p.add_argument('--init-weights', default=None, type=_existing,
                   help='Detectron2 checkpoint (.pkl/.pth) to initialize from '
                        '(reference default: COCO keypoint_rcnn_R_50_FPN_3x zoo weights)')
    p.add_argument('--device', default='cuda', help='Device that trains (cuda, or cpu)')
    p.add_argument('--log-period', default=20, type=int_range(min=1), help='Steps between rows of metrics.jsonl')
    return p


def train(argv: Sequence[str]) -> str:
    '''Run the ``train`` command; returns the model dir.'''
    args = train_parser().parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.device import resolve_device
    from moseq2_detectron_extract_tpu_torch.io.annot import load_annotations_helper
    from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig, get_base_config
    from moseq2_detectron_extract_tpu_torch.models.trainer import Trainer

    device = resolve_device(args.device)
    setup_logging()
    load_annotations_helper(args.annot_files, 'RGB',
                            replace_paths=_replace_pairs(args.replace_paths), register=True)

    cfg = get_base_config()
    if args.config_yaml:
        cfg = ModelConfig.from_yaml(args.config_yaml)
    if args.max_iter:
        cfg = cfg.replace(max_iter=int(args.max_iter))
    ensure_dir(args.model_dir)
    cfg.to_yaml(os.path.join(args.model_dir, 'config.yaml'))
    trainer = Trainer(cfg, args.model_dir, log_period=args.log_period, device=device)
    trainer.resume_or_load(resume=args.resume)
    if args.init_weights and not args.resume:
        from moseq2_detectron_extract_tpu_torch.models.convert import convert_checkpoint
        model = trainer.state.model
        state, _ = convert_checkpoint(args.init_weights, model.state_dict())
        model.load_state_dict(state)
    trainer.train()
    return args.model_dir


def convert_weights(argv: Sequence[str]) -> str:
    '''Convert a Detectron2 ``.pkl``/``.pth`` checkpoint (the zoo's
    ``keypoint_rcnn_R_50_FPN_3x`` weights the reference trains from) into a
    model dir: ``config.yaml`` and ``checkpoints/model_0000000.pt``. Heads
    of another shape (17 COCO keypoints against 8) keep a fresh
    initialisation and are reported. Returns the checkpoint's path.'''
    p = argparse.ArgumentParser(prog='convert-weights', allow_abbrev=False,
                                description='Convert a Detectron2 checkpoint to a model dir')
    p.add_argument('src', metavar='SRC', type=_existing)
    p.add_argument('--model-dir', required=True, help='Output model directory')
    p.add_argument('--config', dest='config_yaml', default=None, type=_existing,
                   help='Model config yaml to use (defaults to base config)')
    args = p.parse_args(list(argv))
    import torch

    from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir
    from moseq2_detectron_extract_tpu_torch.models.checkpoint import save_checkpoint
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig, get_base_config
    from moseq2_detectron_extract_tpu_torch.models.convert import convert_checkpoint
    from moseq2_detectron_extract_tpu_torch.models.rcnn import MaskKeypointRCNN
    from moseq2_detectron_extract_tpu_torch.models.train import init_flax_defaults

    setup_logging()
    cfg = ModelConfig.from_yaml(args.config_yaml) if args.config_yaml else get_base_config()
    template = init_flax_defaults(MaskKeypointRCNN(cfg), torch.Generator().manual_seed(0))
    state, report = convert_checkpoint(args.src, template.state_dict())
    ensure_dir(args.model_dir)
    cfg.to_yaml(os.path.join(args.model_dir, 'config.yaml'))
    path = save_checkpoint(args.model_dir, 0, {'step': 0, 'model': state})
    print(f'loaded {len(report["loaded"])} tensors, '
          f'{len(report["shape_mismatch"])} kept initialization '
          f'(shape mismatch), {len(report["unused"])} source keys unused')
    print(f'wrote {path}')
    return path


def _log_results(results, prefix: str = '') -> None:
    for task, metrics in results.items():
        logging.info('%s%s: %s', prefix, task, metrics)


def evaluate(argv: Sequence[str]):
    '''COCO-style AP (bbox, segm, keypoints with the config's OKS sigmas)
    of a model dir over the test split of annotations; returns the results.'''
    p = argparse.ArgumentParser(prog='evaluate', allow_abbrev=False,
                                description='Evaluate a model checkpoint')
    p.add_argument('annot_files', metavar='ANNOT_FILES', nargs='*', type=_existing)
    p.add_argument('--model-dir', required=True, type=_existing)
    p.add_argument('--checkpoint', default='last')
    p.add_argument('--replace-paths', default=None, action='append')
    p.add_argument('--device', default='cuda', help='Device that runs the model (cuda, or cpu)')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.io.annot import (dataset_catalog_get,
                                                             load_annotations_helper)
    from moseq2_detectron_extract_tpu_torch.models.eval import evaluate_model

    setup_logging()
    load_annotations_helper(args.annot_files, 'RGB',
                            replace_paths=_replace_pairs(args.replace_paths), register=True)
    results = evaluate_model(args.model_dir, dataset_catalog_get('moseq_test'),
                             checkpoint=args.checkpoint, device=args.device)
    _log_results(results)
    return results


def compile_model(argv: Sequence[str]):
    '''Export a model dir (``models/deploy.py``: config, checkpoint and a
    ``torch.export`` program at a fixed batch and canvas), then evaluate
    any EVAL_ANNOT_FILES through the loaded program (the reference's
    post-export COCO evaluation). Returns (the export dir, the results or
    None).'''
    p = argparse.ArgumentParser(prog='compile-model', allow_abbrev=False,
                                description='Export a model')
    p.add_argument('eval_annot_files', metavar='EVAL_ANNOT_FILES', nargs='*', type=_existing)
    p.add_argument('--model-dir', required=True, type=_existing)
    p.add_argument('--checkpoint', default='last')
    p.add_argument('--output', default=None, help='Output path for the exported model archive')
    p.add_argument('--batch-size', default=10, type=int)
    p.add_argument('--image-size', default=None, type=optional(int))
    p.add_argument('--replace-paths', default=None, action='append')
    p.add_argument('--device', default='cuda', help='Device that runs the model (cuda, or cpu)')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.models.deploy import (export_model,
                                                                  load_exported_model)
    setup_logging()
    out = export_model(args.model_dir, checkpoint=args.checkpoint, output=args.output,
                       batch_size=args.batch_size, image_size=args.image_size,
                       device=args.device)
    logging.info('Exported model to %s', out)
    results = None
    if args.eval_annot_files:
        from moseq2_detectron_extract_tpu_torch.io.annot import (dataset_catalog_get,
                                                                 load_annotations_helper)
        from moseq2_detectron_extract_tpu_torch.models.eval import evaluate_model
        load_annotations_helper(args.eval_annot_files, 'RGB',
                                replace_paths=_replace_pairs(args.replace_paths), register=True)
        predictor = load_exported_model(out, device=args.device)
        results = evaluate_model(out, dataset_catalog_get('moseq_test'), predictor=predictor)
        _log_results(results, 'post-export ')
    return out, results


def infer_dataset(argv: Sequence[str]) -> str:
    '''Run the model over Label Studio tasks and write pre-annotations
    (polygons and keypoints); returns the output's path.'''
    p = argparse.ArgumentParser(prog='infer-dataset', allow_abbrev=False,
                                description='Pre-annotate dataset tasks with model predictions')
    p.add_argument('tasks_file', metavar='TASKS_FILE', type=_existing)
    p.add_argument('--model-dir', required=True, type=_existing)
    p.add_argument('--checkpoint', default='last')
    p.add_argument('--output', default=None)
    p.add_argument('--instance-threshold', default=0.5, type=float)
    p.add_argument('--device', default='cuda', help='Device that runs the model (cuda, or cpu)')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.dataset import write_predictions_as_annotations
    setup_logging()
    out = write_predictions_as_annotations(args.tasks_file, args.model_dir,
                                           checkpoint=args.checkpoint, output=args.output,
                                           instance_threshold=args.instance_threshold,
                                           device=args.device)
    logging.info('Wrote pre-annotations to %s', out)
    return out


def find_roi(argv: Sequence[str]):
    '''Find and cache a session's ROI and background (``first_frame.tiff``,
    ``bground.tiff``, ``roi_<index>.tiff`` in ``--output-dir``, default the
    session's ``proc``); returns the session.'''
    p = argparse.ArgumentParser(prog='find-roi', allow_abbrev=False,
                                description='Finds the ROI and background image')
    p.add_argument('input_file', metavar='INPUT_FILE', type=_existing_file)
    _add_bg_roi_options(p)
    p.add_argument('--output-dir', default=None)
    p.add_argument('--device', default='cuda', help='Device that runs the ROI search (cuda, or cpu)')
    args = _typed_defaults(p).parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.device import resolve_device
    from moseq2_detectron_extract_tpu_torch.io.session import Session
    from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir

    device = resolve_device(args.device)
    setup_logging()
    session = Session(args.input_file)
    output_dir = args.output_dir or os.path.join(session.dirname, 'proc')
    ensure_dir(output_dir)
    session.find_roi(bg_roi_dilate=tuple(args.bg_roi_dilate), bg_roi_shape=args.bg_roi_shape,
                     bg_roi_index=args.bg_roi_index, bg_roi_weights=tuple(args.bg_roi_weights),
                     bg_roi_depth_range=tuple(args.bg_roi_depth_range),
                     bg_roi_gradient_filter=args.bg_roi_gradient_filter,
                     bg_roi_gradient_threshold=args.bg_roi_gradient_threshold,
                     bg_roi_gradient_kernel=args.bg_roi_gradient_kernel,
                     bg_roi_fill_holes=args.bg_roi_fill_holes,
                     use_plane_bground=args.use_plane_bground,
                     cache_dir=output_dir, verbose=True, device=device)
    logging.info('Detected true depth: %s', session.true_depth)
    return session


def convert_raw_to_avi(argv: Sequence[str]) -> str:
    '''Losslessly compress raw 16-bit depth into an FFV1 AVI (about 8x
    smaller), read it back chunk by chunk and compare it with the raw frames
    bit for bit, then delete the raw file if asked; returns the AVI's path.'''
    p = argparse.ArgumentParser(prog='convert-raw-to-avi', allow_abbrev=False,
                                description='Convert raw .dat to lossless ffv1 avi')
    p.add_argument('input_file', metavar='INPUT_FILE', type=_existing_file)
    p.add_argument('-o', '--output-file', default=None)
    p.add_argument('-b', '--chunk-size', default=3000, type=int)
    p.add_argument('--fps', default=30, type=int)
    p.add_argument('--delete', action='store_true',
                   help='Delete the input file after verification')
    p.add_argument('-t', '--threads', default=3, type=int)
    args = p.parse_args(list(argv))
    import numpy as np
    from moseq2_detectron_extract_tpu_torch.io.video import (get_raw_info, open_ffv1_reader,
                                                             read_frames, read_frames_raw,
                                                             write_frames)
    setup_logging()
    output_file = args.output_file or os.path.splitext(args.input_file)[0] + '.avi'
    nframes = get_raw_info(args.input_file)['nframes']
    chunks = [list(range(s, min(s + args.chunk_size, nframes)))
              for s in range(0, nframes, args.chunk_size)]
    pipe = None
    for idxs in chunks:
        pipe = write_frames(output_file, read_frames_raw(args.input_file, idxs),
                            threads=args.threads, fps=args.fps, close_pipe=False, pipe=pipe)
    if pipe is not None:
        pipe.stdin.close()
        pipe.wait()

    logging.info('Verifying conversion...')
    reader = open_ffv1_reader(output_file)
    try:
        for idxs in chunks:
            raw = read_frames_raw(args.input_file, idxs)
            avi = read_frames(output_file, idxs, threads=args.threads, fps=args.fps,
                              reader=reader)
            if not np.array_equal(raw.astype('uint16'), avi):
                raise RuntimeError(f'Conversion mismatch in frames {idxs[0]}-{idxs[-1]}')
    finally:
        reader.close()
    logging.info('Conversion verified byte-exact')
    if args.delete:
        os.remove(args.input_file)
    return output_file


def generate_dataset(argv: Sequence[str]) -> str:
    '''Sample session frames to PNGs and Label Studio tasks; returns the
    tasks file's path.'''
    p = argparse.ArgumentParser(prog='generate-dataset', allow_abbrev=False,
                                description='Sample frames for annotation')
    p.add_argument('input_files', metavar='INPUT_FILES', nargs='*', type=_existing_file)
    p.add_argument('--output-dir', required=True)
    p.add_argument('--num-samples', default=100, type=int)
    p.add_argument('--sample-method', default='random',
                   choices=['random', 'uniform', 'kmeans', 'list'])
    p.add_argument('--frame-indices', default=None,
                   help='Comma-separated indices for sample-method=list')
    p.add_argument('--min-height', default=0, type=int)
    p.add_argument('--max-height', default=100, type=int)
    p.add_argument('--bg-roi-depth-range', default=(650, 750), nargs=2, type=float)
    p.add_argument('--with-rgb', action='store_true',
                   help='Also export RGB frames when available')
    p.add_argument('--device', default='cuda',
                   help='Device of the ROI search, the prep and the k-means (cuda, or cpu)')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.dataset import (generate_dataset_for_sessions,
                                                            write_label_studio_tasks)
    from moseq2_detectron_extract_tpu_torch.device import resolve_device
    setup_logging()
    indices = [int(i) for i in args.frame_indices.split(',')] if args.frame_indices else None
    tasks = generate_dataset_for_sessions(
        list(args.input_files), args.output_dir, num_samples=args.num_samples,
        sample_method=args.sample_method, frame_indices=indices, min_height=args.min_height,
        max_height=args.max_height, bg_roi_depth_range=tuple(args.bg_roi_depth_range),
        with_rgb=args.with_rgb, device=resolve_device(args.device))
    tasks_path = write_label_studio_tasks(tasks, args.output_dir)
    logging.info('Wrote %d tasks to %s', len(tasks), tasks_path)
    return tasks_path


def _preview_parser(prog: str, description: str, input_name: str) -> argparse.ArgumentParser:
    '''The two preview commands' options (``cli.py:362-394``).'''
    p = argparse.ArgumentParser(prog=prog, description=description, allow_abbrev=False)
    p.add_argument(input_name, metavar=input_name.upper(), type=_existing_file)
    p.add_argument('-o', '--output-file', default=None)
    p.add_argument('--min-height', default=0, type=int)
    p.add_argument('--max-height', default=100, type=int)
    p.add_argument('--chunk-size', default=1000, type=int)
    p.add_argument('--fps', default=30, type=int)
    p.add_argument('--device', default='cuda', help='Device of the ROI search or the '
                                                     'reverse crop-rotate (cuda, or cpu)')
    return p


def visualize_raw(argv: Sequence[str]) -> str:
    '''Background-subtracted preview movie of a raw session; returns its path.'''
    args = _preview_parser('visualize-raw', 'Preview movie of a raw session',
                           'input_file').parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.viz import generate_raw_preview
    setup_logging()
    out = generate_raw_preview(args.input_file, args.output_file, min_height=args.min_height,
                               max_height=args.max_height, chunk_size=args.chunk_size,
                               fps=args.fps, device=args.device)
    logging.info('Wrote preview to %s', out)
    return out


def visualize_result(argv: Sequence[str]) -> str:
    '''Re-render a preview movie from a results file; returns its path.'''
    args = _preview_parser('visualize-result', 'Re-render preview movie from result h5',
                           'result_file').parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.viz import H5ResultPreviewVideoGenerator
    setup_logging()
    out = H5ResultPreviewVideoGenerator(args.result_file, args.output_file,
                                        vmin=args.min_height, vmax=args.max_height,
                                        chunk_size=args.chunk_size, fps=args.fps,
                                        device=args.device).generate()
    logging.info('Wrote preview to %s', out)
    return out


def dataset_info(argv: Sequence[str]) -> None:
    '''Log the statistics of annotation exports (``io/annot.py:show_dataset_info``).'''
    p = argparse.ArgumentParser(prog='dataset-info', allow_abbrev=False,
                                description='Show dataset statistics')
    p.add_argument('annot_files', metavar='ANNOT_FILES', nargs='*', type=_existing)
    p.add_argument('--replace-paths', default=None, action='append')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.io.annot import load_annotations_helper
    setup_logging()
    load_annotations_helper(args.annot_files, 'RGB',
                            replace_paths=_replace_pairs(args.replace_paths),
                            register=False, show_info=True)


def _result_parser(prog: str, description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=description, allow_abbrev=False)
    p.add_argument('result_file', metavar='RESULT_FILE', type=_existing_file)
    return p


def find_outliers(argv: Sequence[str]) -> dict:
    '''Search a results file for outlier frames and write the reports
    (``quality.py``); returns each detector's frames.'''
    p = _result_parser('find-outliers', 'Outlier frame detection on a result h5')
    p.add_argument('--window', default=4, type=int)
    p.add_argument('--threshold', default=10.0, type=float)
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.quality import find_outliers_h5
    setup_logging()
    return find_outliers_h5(args.result_file, jumping_window=args.window,
                            jumping_thresh=args.threshold)


def _backup(result_file: str) -> None:
    import shutil
    from moseq2_detectron_extract_tpu_torch.io.util import find_unused_file_path
    backup = find_unused_file_path(result_file + '.bak')
    shutil.copy2(result_file, backup)
    logging.info('Backed up results to %s', backup)


def manual_flip(argv: Sequence[str]) -> None:
    '''Apply the ranges of a flips file to a results file (``io/flips.py``),
    after copying it to ``<result>.bak`` (``.bak.N`` if taken) unless
    ``--no-backup``.'''
    p = _result_parser('manual-flip', 'Apply human flip corrections to a result h5')
    p.add_argument('flips_file', metavar='FLIPS_FILE', type=_existing_file)
    p.add_argument('--no-backup', action='store_true',
                   help='Skip backing up the h5 before flipping')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.io.flips import (count_frames, flip_dataset,
                                                             read_flips_file)
    setup_logging()
    nframes = count_frames(args.result_file)
    ranges = read_flips_file(args.flips_file, verify=True, verify_vmax=nframes)
    if not args.no_backup:
        _backup(args.result_file)
    flip_dataset(args.result_file, flip_ranges=ranges)
    logging.info('Applied %d flip ranges', len(ranges))


def verify_flips(argv: Sequence[str]) -> None:
    '''Check flips files (parse, bounds, overlaps); exits with 1 if any fails.'''
    p = argparse.ArgumentParser(prog='verify-flips', description='Lint flips files',
                                allow_abbrev=False)
    p.add_argument('flips_files', metavar='FLIPS_FILES', nargs='*', type=_existing_file)
    p.add_argument('--max-frames', default=None, type=optional(int))
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.io.flips import read_flips_file
    setup_logging()
    failed = False
    for path in args.flips_files:
        try:
            ranges = read_flips_file(path, verify=True,
                                     verify_vmax=args.max_frames or sys.maxsize)
            logging.info('%s: OK (%d ranges)', path, len(ranges))
        except RuntimeError as exc:
            logging.error('%s: FAILED\n%s', path, exc)
            failed = True
    if failed:
        raise SystemExit(1)


def trim_result(argv: Sequence[str]) -> None:
    '''Cut a results file to frames ``[start, stop)`` (``io/result.py:
    trim_results``), after copying it to ``<result>.bak`` unless
    ``--no-backup``.'''
    p = _result_parser('trim-result', 'Truncate result h5 datasets to a frame range')
    p.add_argument('--start', required=True, type=int)
    p.add_argument('--stop', required=True, type=int)
    p.add_argument('--no-backup', action='store_true')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.io.result import trim_results
    setup_logging()
    if not args.no_backup:
        _backup(args.result_file)
    trim_results(args.result_file, args.start, args.stop)
    logging.info('Trimmed results to frames [%d, %d)', args.start, args.stop)


def generate_extract_config(argv: Sequence[str]) -> str:
    '''Write the ``extract`` options' defaults to a YAML file that ``extract
    --config-file`` reads; returns its path. As the reference's
    ``get_command_defaults(extract)``, the options that declare no default
    there (``--model``, ``--config-file``) are left out; ``device`` is the
    port's own.'''
    p = argparse.ArgumentParser(prog='generate-extract-config', allow_abbrev=False,
                                description='Dump extract defaults to yaml')
    p.add_argument('--output-file', '-o', default='extract-config.yaml')
    args = p.parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.io.util import write_yaml
    write_yaml(args.output_file, {a.dest: a.default for a in extract_parser()._actions
                                  if a.option_strings
                                  and a.dest not in ('help', 'model', 'config_file')})
    print(f'Successfully generated extract config file at "{args.output_file}".')
    return args.output_file


def extract_batch_parser() -> argparse.ArgumentParser:
    '''The ``extract-batch`` command's options.'''
    p = argparse.ArgumentParser(prog='extract-batch', allow_abbrev=False,
                                description='Generate extract commands for many sessions')
    p.add_argument('input_dir', metavar='INPUT_DIR', type=_existing_dir)
    p.add_argument('--model', required=True, type=_existing)
    p.add_argument('--config-file', default=None, type=_existing)
    p.add_argument('--cluster-type', default='local', choices=['local', 'slurm'])
    p.add_argument('--slurm-partition', default='main')
    p.add_argument('--slurm-ncpus', default=4, type=int)
    p.add_argument('--slurm-memory', default='16GB')
    p.add_argument('--slurm-wall-time', default='3:00:00')
    p.add_argument('--prefix', default=None, help='Command prefix (e.g. environment activation)')
    p.add_argument('--extension', default='.dat')
    p.add_argument('--bg-roi-index', default=0, type=int)
    p.add_argument('--in-process', action='store_true',
                   help='Run the extractions now, one session per local CUDA device at a '
                        'time, instead of printing commands')
    p.add_argument('--max-concurrent', default=None, type=optional(int),
                   help='With --in-process: sessions running at once (default: one per '
                        'device)')
    p.add_argument('--device', default='cuda',
                   help='With --in-process: cuda (every CUDA device), cuda:N, or cpu')
    return p


def extract_batch(argv: Sequence[str]) -> None:
    '''Print one ``extract`` command per unextracted session under
    ``INPUT_DIR`` (files ending in ``--extension``, and ``.tar.gz``/``.tgz``
    archives), to run here one after another or, with ``--cluster-type
    slurm``, each as an ``sbatch`` job; or with ``--in-process`` extract them
    now on the local CUDA devices (``parallel.sessions``) and print each
    session's status file; exit code 1 when a session failed (it raised, or
    its status does not say ``complete: true``).'''
    args = extract_batch_parser().parse_args(list(argv))
    from moseq2_detectron_extract_tpu_torch.io.util import (read_yaml,
                                                            scan_unextracted_sessions,
                                                            wrap_command_with_local,
                                                            wrap_command_with_slurm)
    setup_logging()
    sessions = scan_unextracted_sessions(args.input_dir, extension=args.extension,
                                         bg_roi_index=args.bg_roi_index)
    if args.in_process:
        _extract_batch_in_process(args, sessions, read_yaml)
        return
    commands = []
    for session_path in sessions:
        cmd = f'python -m moseq2_detectron_extract_tpu_torch.cli extract --model {args.model}'
        if args.config_file:
            cmd += f' --config-file {args.config_file}'
        commands.append(f'{cmd} {session_path}')
    if args.cluster_type == 'slurm':
        commands = wrap_command_with_slurm(commands, prefix=args.prefix,
                                           partition=args.slurm_partition,
                                           ncpus=args.slurm_ncpus, memory=args.slurm_memory,
                                           wall_time=args.slurm_wall_time)
    else:
        commands = wrap_command_with_local(commands, args.input_dir)
    for cmd in commands:
        print(cmd)


def _extract_batch_in_process(args, sessions, read_yaml) -> None:
    '''``extract-batch --in-process``: the extract defaults, then the config
    file's keys, then the model and the reference's fixed keys, each
    session extracted by ``extract_sessions_sharded``.'''
    from moseq2_detectron_extract_tpu_torch.parallel.sessions import extract_sessions_sharded
    from moseq2_detectron_extract_tpu_torch.proc.util import check_completion_status
    if not sessions:
        print('No unextracted sessions found.')
        return
    parser = extract_parser()
    defaults = {a.dest: a.default for a in parser._actions
                if a.option_strings and a.dest != 'help'}
    config = dict(defaults)
    if args.config_file:
        for key, value in (read_yaml(args.config_file) or {}).items():
            key = key.replace('-', '_')
            if isinstance(defaults.get(key), tuple) and value is not None:
                value = tuple(value)
            config[key] = value
    config.update({'model': args.model, 'bg_roi_index': args.bg_roi_index,
                   'output_dir': None, 'use_tracking_model': False,
                   'flip_classifier': args.model, 'dataset_name': 'moseq',
                   'param_annotations': click_param_annot(parser)})
    if config.get('allowed_detections') is None:
        config['allowed_detections'] = (config['expected_instances'] + 1) * 2
    devices = None if args.device == 'cuda' else [args.device]
    results = extract_sessions_sharded(sessions, config, devices=devices,
                                       max_concurrent=args.max_concurrent)
    failed = [s for s in sessions
              if s not in results or not check_completion_status(results[s])]
    for path, status in results.items():
        print(f'{path}: {status}')
    for path in failed:
        print(f'{path}: FAILED (see log)')
    if failed:
        raise SystemExit(1)


def system_info(argv: Sequence[str]) -> None:
    '''Print the versions (the port, Python, torch, CUDA, cuDNN, numpy) and
    each CUDA device with its used and total memory.'''
    argparse.ArgumentParser(prog='system-info', allow_abbrev=False,
                            description='Show framework and device info').parse_args(list(argv))
    import numpy as np
    import torch
    from moseq2_detectron_extract_tpu_torch import __version__
    print(f'moseq2-detectron-extract-tpu-torch: {__version__}')
    print(f'python: {sys.version.split()[0]}')
    print(f'torch: {torch.__version__}')
    print(f'cuda: {torch.version.cuda}')
    cudnn = torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None
    print(f'cudnn: {cudnn}')
    print(f'numpy: {np.__version__}')
    if not torch.cuda.is_available():
        print('no CUDA device')
        return
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        print(f'  device {i}: {torch.cuda.get_device_name(i)} '
              f'({(total - free) / 2 ** 30:.2f}/{total / 2 ** 30:.2f} GiB)')


COMMANDS = {'extract': extract, 'train': train, 'convert-weights': convert_weights,
            'evaluate': evaluate, 'compile-model': compile_model,
            'infer-dataset': infer_dataset, 'find-roi': find_roi,
            'convert-raw-to-avi': convert_raw_to_avi, 'generate-dataset': generate_dataset,
            'visualize-raw': visualize_raw, 'visualize-result': visualize_result,
            'dataset-info': dataset_info, 'find-outliers': find_outliers,
            'manual-flip': manual_flip, 'verify-flips': verify_flips,
            'trim-result': trim_result, 'generate-extract-config': generate_extract_config,
            'extract-batch': extract_batch, 'system-info': system_info}


def main(argv: Optional[List[str]] = None) -> int:
    '''``<command> [options]``; returns the exit code.'''
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f'usage: python -m moseq2_detectron_extract_tpu_torch.cli '
              f'{{{",".join(COMMANDS)}}} ...', file=sys.stderr)
        return 2
    if os.environ.get('MOSEQ_DETECTRON_PROFILE'):
        from moseq2_detectron_extract_tpu_torch.utils.profiling import enable_profiling
        enable_profiling()
    try:
        COMMANDS[argv[0]](argv[1:])
    except SystemExit as exc:   # a command's own exit code, or argparse's
        return exc.code if isinstance(exc.code, int) else int(exc.code is not None)
    return 0


if __name__ == '__main__':
    sys.exit(main())
