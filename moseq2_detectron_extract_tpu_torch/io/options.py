'''Command options on ``argparse``: click's option types, defaults from a
config file, and the options' help strings.

The port's counterpart of ``moseq2_detectron_extract_tpu/io/click.py`` (the
card's machine has no click): ``optional`` is ``OptionalParamType``,
``int_range``/``float_range``/``click_bool`` are click's ``IntRange``,
``FloatRange`` and ``BOOL``; ``apply_config_file`` gives
``command_with_config``'s precedence (the command line's own values, then
the config file's, then the defaults); ``click_param_annot`` reads a
parser's help strings as the reference reads a click command's.
'''
import argparse
from typing import Dict, List, Optional, Sequence

from moseq2_detectron_extract_tpu_torch.io.util import read_yaml

_TRUE = {'1', 'true', 't', 'yes', 'y', 'on'}
_FALSE = {'0', 'false', 'f', 'no', 'n', 'off'}


def click_bool(text: str) -> bool:
    '''A boolean option's value, as click's ``BOOL`` reads it.'''
    value = str(text).strip().lower()
    if value in _TRUE:
        return True
    if value in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f'{text!r} is not a valid boolean')


def int_range(min: Optional[int] = None, max: Optional[int] = None):
    def convert(text: str) -> int:
        value = int(text)
        if (min is not None and value < min) or (max is not None and value > max):
            raise argparse.ArgumentTypeError(f'{value} is not in the range {min}..{max}')
        return value
    convert.__name__ = 'integer range'
    return convert


def float_range(min: Optional[float] = None, max: Optional[float] = None):
    def convert(text: str) -> float:
        value = float(text)
        if (min is not None and value < min) or (max is not None and value > max):
            raise argparse.ArgumentTypeError(f'{value} is not in the range {min}..{max}')
        return value
    convert.__name__ = 'float range'
    return convert


def optional(convert):
    '''A type that also takes None, '' or 'None' as None.'''
    def wrapped(text):
        if text is None or text in ('', 'None'):
            return None
        return convert(text)
    wrapped.__name__ = f'optional {getattr(convert, "__name__", "value")}'
    return wrapped


def _option_actions(parser: argparse.ArgumentParser) -> List[argparse.Action]:
    return [a for a in parser._actions
            if a.option_strings and not isinstance(a, argparse._HelpAction)]


def explicit_dests(parser: argparse.ArgumentParser, argv: Sequence[str]) -> set:
    '''The options given on the command line (the parser takes no
    abbreviations, so each is spelled out).'''
    given = set()
    for action in _option_actions(parser):
        for token in argv:
            if token == '--':
                break
            if token.split('=', 1)[0] in action.option_strings:
                given.add(action.dest)
    return given


def apply_config_file(parser: argparse.ArgumentParser, args: argparse.Namespace,
                      argv: Sequence[str], config_param: str = 'config_file') -> None:
    '''Fill ``args`` from the YAML file named by ``args.<config_param>``: a
    key (``snake_case`` or ``kebab-case``) takes the place of an option's
    default, never of a value given on the command line; a list becomes a
    tuple where the default is one.'''
    path = getattr(args, config_param, None)
    if path is None:
        return
    config_data = read_yaml(path) or {}
    given = explicit_dests(parser, argv)
    for param, value in vars(args).items():
        alt_name = param.replace('_', '-')
        if param in given or (param not in config_data and alt_name not in config_data):
            continue
        config_value = config_data.get(param, config_data.get(alt_name))
        if isinstance(value, tuple) and config_value is not None:
            config_value = tuple(config_value)
        setattr(args, param, config_value)


def click_param_annot(parser: argparse.ArgumentParser) -> Dict[str, Optional[str]]:
    '''Each option's help string (None without one), for the results file's
    ``description`` attributes.'''
    return {a.dest: a.help for a in _option_actions(parser)}
