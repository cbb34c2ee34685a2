'''The command line of the port: the ``extract`` and ``train`` commands.

    python -m moseq2_detectron_extract_tpu_torch.cli extract <depth.dat> \
        --model benchmarks/bench_model_fast160 [--device cpu] [--output-dir DIR]
    python -m moseq2_detectron_extract_tpu_torch.cli train <export.json> \
        --model-dir DIR [--config YAML] [--max-iter N] [--resume] [--device cpu]

Port of ``moseq2_detectron_extract_tpu/cli.py:37-129`` on ``argparse``: the
same option names, defaults and help strings, ``--config-file`` as
``io/click.py:command_with_config`` gives it, the ``allowed_detections``
rule, and the config keys ``use_tracking_model``, ``flip_classifier``,
``dataset_name`` and ``param_annotations``. ``--device`` (default
``cuda``) is the port's own. ``--report-outliers`` and
``--device-input prescaled`` are not ported yet and raise.

``train`` is ``cli.py:131-166``: the same options; ``--device`` (default
``cuda``) and ``--log-period`` (the metrics' period, 20 as in the JAX
trainer) are the port's own. ``--init-weights`` needs the Detectron2
checkpoint converter, which is not ported yet: it raises.
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


def _existing_file(path: str) -> str:
    if not os.path.isfile(_existing(path)):
        raise argparse.ArgumentTypeError(f'{path!r} is a directory')
    return path


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
    # click passes a default through the option's type, as a given value:
    # (650, 750) of a float pair is (650.0, 750.0)
    for action in p._actions:
        if action.type is not None and action.default is not None \
                and not isinstance(action.default, str):
            action.default = tuple(map(action.type, action.default)) \
                if isinstance(action.default, tuple) else action.type(action.default)
    return p


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
    if args.report_outliers:
        raise NotImplementedError('--report-outliers is not ported yet (find_outliers_h5)')
    if args.device_input != 'full':
        raise NotImplementedError("--device-input prescaled is not ported yet (it resizes on "
                                  "the host with cv2)")

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
    return extract_session(session=session, config=config_data)


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
    if args.init_weights:
        raise NotImplementedError('--init-weights is not ported yet (it needs the Detectron2 '
                                  'checkpoint converter, models/convert.py)')
    from moseq2_detectron_extract_tpu_torch.device import resolve_device
    from moseq2_detectron_extract_tpu_torch.io.annot import load_annotations_helper
    from moseq2_detectron_extract_tpu_torch.io.util import ensure_dir
    from moseq2_detectron_extract_tpu_torch.models.config import ModelConfig, get_base_config
    from moseq2_detectron_extract_tpu_torch.models.trainer import Trainer

    device = resolve_device(args.device)
    setup_logging()
    replace = [tuple(rp.split(':', 1)) for rp in args.replace_paths] \
        if args.replace_paths else None
    load_annotations_helper(args.annot_files, 'RGB', replace_paths=replace, register=True)

    cfg = get_base_config()
    if args.config_yaml:
        cfg = ModelConfig.from_yaml(args.config_yaml)
    if args.max_iter:
        cfg = cfg.replace(max_iter=int(args.max_iter))
    ensure_dir(args.model_dir)
    cfg.to_yaml(os.path.join(args.model_dir, 'config.yaml'))
    trainer = Trainer(cfg, args.model_dir, log_period=args.log_period, device=device)
    trainer.resume_or_load(resume=args.resume)
    trainer.train()
    return args.model_dir


COMMANDS = {'extract': extract, 'train': train}


def main(argv: Optional[List[str]] = None) -> int:
    '''``<command> [options]``; returns the exit code.'''
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f'usage: python -m moseq2_detectron_extract_tpu_torch.cli '
              f'{{{",".join(COMMANDS)}}} ...', file=sys.stderr)
        return 2
    COMMANDS[argv[0]](argv[1:])
    return 0


if __name__ == '__main__':
    sys.exit(main())
