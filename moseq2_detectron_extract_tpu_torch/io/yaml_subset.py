'''A YAML emitter and reader for the block-style subset that the port writes
and reads, without PyYAML (the card's machine has none).

``dump`` writes nested dicts, lists, str, int, float (NaN and inf included),
bool and None in PyYAML's ``safe_dump`` layout: block style, keys sorted,
two-space indent, a list under a key at the key's indent. A string that a
YAML 1.1 loader would read as something else (``'yes'``, ``'null'``,
``'0650'``, ``'1e3'``, a date, one with ``': '`` or a leading space, the
empty string) is single-quoted, and one with a line break or another
non-printable character double-quoted with escapes. Lines are never wrapped.

``load`` reads what ``dump`` writes and what PyYAML's ``safe_dump`` writes
for the extract config and the status file: block mappings and sequences
(a sequence under a key at the key's indent or deeper, ``- - x`` and
``- key: v`` items), the flow forms ``[]``, ``{}`` and one-line ``[a, b]``,
plain, single- and double-quoted scalars folded across lines, and comments.
Scalars resolve as PyYAML's ``SafeLoader`` resolves them (YAML 1.1: ``yes``
is true, ``0650`` is octal, ``1e3`` is a string); a plain date stays a
string. Anchors, tags, block scalars and non-empty flow mappings raise
``ValueError``.
'''
import math
import re
from typing import Any, List, Optional, Tuple

_NULLS = {'', '~', 'null', 'Null', 'NULL'}
_BOOLS = {**{w: True for w in ('yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON')},
          **{w: False for w in ('no', 'No', 'NO', 'false', 'False', 'FALSE', 'off', 'Off',
                                'OFF')}}
# PyYAML's implicit int and float resolvers (resolver.py)
_INT_RE = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_FLOAT_RE = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_TIMESTAMP_RE = re.compile(r'^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?')
_PLAIN_SAFE = re.compile(r'^[A-Za-z_/][A-Za-z0-9_ ./@+=()<>$%^~-]*$')


# -- resolving plain scalars -----------------------------------------------------

def _sexagesimal(text: str, cast):
    value, base = 0, 1
    for part in reversed(text.split(':')):
        value += cast(part) * base
        base *= 60
    return value


def resolve_plain(text: str) -> Any:
    '''A plain scalar's value, as PyYAML's SafeLoader resolves it.'''
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT_RE.match(text):
        digits = text.replace('_', '')
        sign = -1 if digits[0] == '-' else 1
        digits = digits.lstrip('+-')
        if digits == '0':
            return 0
        if digits.startswith('0b'):
            return sign * int(digits[2:], 2)
        if digits.startswith('0x'):
            return sign * int(digits[2:], 16)
        if digits.startswith('0'):
            return sign * int(digits, 8)
        if ':' in digits:
            return sign * _sexagesimal(digits, int)
        return sign * int(digits)
    if _FLOAT_RE.match(text):
        digits = text.replace('_', '').lower()
        sign = -1.0 if digits[0] == '-' else 1.0
        digits = digits.lstrip('+-')
        if digits == '.inf':
            return sign * math.inf
        if digits == '.nan':
            return math.nan
        if ':' in digits:
            return sign * _sexagesimal(digits, float)
        return sign * float(digits)
    return text


# -- the emitter -------------------------------------------------------------------

def _quote(text: str) -> str:
    if all(ch.isprintable() for ch in text):
        return "'" + text.replace("'", "''") + "'"
    out = []
    for ch in text:
        if ch == '"':
            out.append('\\"')
        elif ch == '\\':
            out.append('\\\\')
        elif ch == '\n':
            out.append('\\n')
        elif ch == '\t':
            out.append('\\t')
        elif ch.isprintable():
            out.append(ch)
        elif ord(ch) <= 0xff:
            out.append(f'\\x{ord(ch):02x}')
        elif ord(ch) <= 0xffff:
            out.append(f'\\u{ord(ch):04x}')
        else:
            out.append(f'\\U{ord(ch):08x}')
    return '"' + ''.join(out) + '"'


def format_scalar(value: Any) -> str:
    '''One scalar as a YAML token.'''
    if value is None:
        return 'null'
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return '.nan'
        if math.isinf(value):
            return '.inf' if value > 0 else '-.inf'
        text = repr(value).lower()
        if '.' not in text and 'e' in text:
            text = text.replace('e', '.0e', 1)
        return text
    if isinstance(value, str):
        plain = (_PLAIN_SAFE.match(value) is not None and value == value.strip()
                 and resolve_plain(value) == value and not _TIMESTAMP_RE.match(value)
                 and ': ' not in value and ' #' not in value and not value.endswith(':'))
        return value if plain else _quote(value)
    raise TypeError(f'cannot write {type(value).__name__} to YAML: {value!r}')


def _sort_keys(mapping: dict):
    try:
        return sorted(mapping)
    except TypeError:
        return list(mapping)


def _emit(value: Any, indent: int, lines: List[str]) -> None:
    pad = ' ' * indent
    if isinstance(value, dict):
        for key in _sort_keys(value):
            item = value[key]
            head = f'{pad}{format_scalar(key)}:'
            if isinstance(item, dict) and item:
                lines.append(head)
                _emit(item, indent + 2, lines)
            elif isinstance(item, list) and item:
                lines.append(head)
                _emit(item, indent, lines)
            else:
                lines.append(f'{head} {_flow_or_scalar(item)}')
    elif isinstance(value, list):
        for item in value:
            if isinstance(item, (dict, list)) and item:
                nested: List[str] = []
                _emit(item, indent + 2, nested)
                nested[0] = f'{pad}- {nested[0][indent + 2:]}'
                lines.extend(nested)
            else:
                lines.append(f'{pad}- {_flow_or_scalar(item)}')
    else:
        lines.append(pad + format_scalar(value))


def _flow_or_scalar(value: Any) -> str:
    if isinstance(value, dict):
        return '{}'
    if isinstance(value, list):
        return '[]'
    return format_scalar(value)


def dump(data: Any) -> str:
    '''YAML text of ``data`` (dicts, lists, str, int, float, bool, None).'''
    lines: List[str] = []
    if isinstance(data, (dict, list)) and data:
        _emit(data, 0, lines)
    else:
        lines.append(_flow_or_scalar(data))
    return '\n'.join(lines) + '\n'


# -- the reader ------------------------------------------------------------------

_KEY_RE = re.compile(r'''^(?P<key>'(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^\s'"\-?:,\[\]{}#&*!|>%@`][^#]*?|-[^\s#][^#]*?)
                         \s*:(?:\s+(?P<rest>.*))?$''', re.X)
_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t', 'n': '\n', 'v': '\v',
            'f': '\f', 'r': '\r', 'e': '\x1b', ' ': ' ', '"': '"', '/': '/', '\\': '\\',
            'N': '\x85', '_': '\xa0', 'L': ' ', 'P': ' '}


class _Lines:
    def __init__(self, text: str):
        self.raw = text.splitlines()
        self.pos = 0

    @staticmethod
    def _blank(line: str) -> bool:
        stripped = line.strip()
        return not stripped or stripped.startswith('#') or stripped == '...' or \
            re.match(r'^---(\s+#.*)?$', stripped) is not None

    def peek(self) -> Optional[Tuple[int, str]]:
        '''The next structural line: (indent, text without indent).'''
        while self.pos < len(self.raw) and self._blank(self.raw[self.pos]):
            self.pos += 1
        if self.pos >= len(self.raw):
            return None
        line = self.raw[self.pos].rstrip()
        if '\t' in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f'tab in indentation: {line!r}')
        return len(line) - len(line.lstrip(' ')), line.lstrip(' ')


def _unescape_double(text: str) -> str:
    out, i = [], 0
    while i < len(text):
        ch = text[i]
        if ch != '\\':
            out.append(ch)
            i += 1
            continue
        code = text[i + 1]
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in 'xuU':
            width = {'x': 2, 'u': 4, 'U': 8}[code]
            out.append(chr(int(text[i + 2:i + 2 + width], 16)))
            i += 2 + width
        else:
            raise ValueError(f'bad escape \\{code}')
    return ''.join(out)


def _fold(pieces: List[str], keep_escaped_breaks: bool) -> str:
    '''Join a multi-line scalar's lines: a break and the spaces around it
    are one space, each empty line a newline; in double quotes a trailing
    backslash joins with none.'''
    last = len(pieces) - 1
    out, empties = '', 0
    for i, piece in enumerate(pieces):
        text = piece.lstrip(' \t') if i else piece
        if i < last:
            text = text.rstrip(' \t')
        if i == 0:
            out = text
            continue
        if not text and i < last:
            empties += 1
            continue
        if keep_escaped_breaks and out.endswith('\\') and \
                (len(out) - len(out.rstrip('\\'))) % 2 == 1:
            out = out[:-1] + text
        else:
            out += ('\n' * empties if empties else ' ') + text
        empties = 0
    return out


def _quoted(lines: _Lines, first: str) -> Any:
    '''A quoted scalar starting at ``first`` (the rest of the current line),
    scanned across lines to its closing quote.'''
    quote = first[0]
    pieces = [first[1:]]
    while True:
        text = pieces[-1]
        i = 0
        while i < len(text):
            if quote == "'" and text[i] == "'":
                if text[i + 1:i + 2] == "'":
                    i += 2
                    continue
                break
            if quote == '"' and text[i] == '\\':
                i += 2
                continue
            if quote == '"' and text[i] == '"':
                break
            i += 1
        if i < len(text):
            pieces[-1], after = text[:i], text[i + 1:].strip()
            if after and not after.startswith('#'):
                raise ValueError(f'text after a quoted scalar: {after!r}')
            lines.pos += 1
            break
        lines.pos += 1
        if lines.pos >= len(lines.raw):
            raise ValueError('unterminated quoted scalar')
        pieces.append(lines.raw[lines.pos])
    if quote == "'":
        return _fold(pieces, False).replace("''", "'")
    return _unescape_double(_fold(pieces, True))


def _split_flow(text: str) -> List[str]:
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
        elif ch in '[{':
            depth += 1
        elif ch in ']}':
            depth -= 1
        elif ch == ',' and depth == 0:
            items.append(text[start:i])
            start = i + 1
    items.append(text[start:])
    return [item.strip() for item in items if item.strip()]


def _flow(text: str) -> Any:
    text = text.strip()
    if text.startswith('['):
        if not text.endswith(']'):
            raise ValueError(f'unsupported flow sequence: {text!r}')
        return [_flow(item) for item in _split_flow(text[1:-1])]
    if text.startswith('{'):
        if text.replace(' ', '') != '{}':
            raise ValueError(f'unsupported flow mapping: {text!r}')
        return {}
    if text[:1] in ('"', "'"):
        lines = _Lines(text)
        return _quoted(lines, text)
    return resolve_plain(text)


def _scalar(lines: _Lines, first: str, parent_indent: int) -> Any:
    '''A scalar whose text starts at ``first`` on the current line; a plain
    one continues on following lines indented past ``parent_indent``.'''
    if first[:1] in ('"', "'"):
        return _quoted(lines, first)
    if first[:1] in ('[', '{'):
        lines.pos += 1
        return _flow(re.sub(r'\s+#.*$', '', first))
    if first[:1] in '&*!|>%@`':
        raise ValueError(f'unsupported YAML construct: {first!r}')
    pieces = [re.sub(r'(^|\s+)#.*$', '', first)]
    lines.pos += 1
    while lines.pos < len(lines.raw):
        raw = lines.raw[lines.pos]
        indent = len(raw) - len(raw.lstrip(' '))
        if raw.strip() and (indent <= parent_indent or raw.strip().startswith('#')):
            break
        if not raw.strip():
            # an empty line belongs to the scalar only if more of it follows
            ahead = lines.pos + 1
            while ahead < len(lines.raw) and not lines.raw[ahead].strip():
                ahead += 1
            if ahead >= len(lines.raw) or \
                    len(lines.raw[ahead]) - len(lines.raw[ahead].lstrip(' ')) <= parent_indent:
                break
        pieces.append(re.sub(r'\s+#.*$', '', raw))
        lines.pos += 1
    return resolve_plain(_fold(pieces, False).strip())


def _node(lines: _Lines, indent: int) -> Any:
    head = lines.peek()
    if head is None or head[0] < indent:
        return None
    col, text = head
    if text == '-' or text.startswith('- '):
        return _sequence(lines, col)
    if _KEY_RE.match(text):
        return _mapping(lines, col)
    return _scalar(lines, text, col - 1)


def _key(text: str) -> Any:
    if text[:1] in ('"', "'"):
        return _quoted(_Lines(text), text)
    return resolve_plain(text.strip())


def _value_after_key(lines: _Lines, rest: str, col: int) -> Any:
    '''The value of a key at column ``col`` whose line continues with ``rest``.'''
    rest = rest.strip()
    if rest and not rest.startswith('#'):
        return _scalar(lines, rest, col)
    lines.pos += 1
    head = lines.peek()
    if head is None:
        return None
    if head[0] > col:
        return _node(lines, head[0])
    if head[0] == col and (head[1] == '-' or head[1].startswith('- ')):
        return _sequence(lines, col)
    return None


def _mapping(lines: _Lines, col: int) -> dict:
    out = {}
    while True:
        head = lines.peek()
        if head is None or head[0] != col:
            if head is not None and head[0] > col:
                raise ValueError(f'bad indentation: {head[1]!r}')
            return out
        m = _KEY_RE.match(head[1])
        if m is None:
            raise ValueError(f'expected a key: {head[1]!r}')
        key = _key(m.group('key'))
        if key in out:
            raise ValueError(f'duplicate key {key!r}')
        out[key] = _value_after_key(lines, m.group('rest') or '', col)


def _sequence(lines: _Lines, col: int) -> list:
    out = []
    while True:
        head = lines.peek()
        if head is None or head[0] != col or not (head[1] == '-' or head[1].startswith('- ')):
            if head is not None and head[0] > col:
                raise ValueError(f'bad indentation: {head[1]!r}')
            return out
        rest = head[1][1:]
        inner = rest.lstrip(' ')
        inner_col = col + 1 + len(rest) - len(inner)
        if not inner or inner.startswith('#'):
            lines.pos += 1
            nxt = lines.peek()
            out.append(_node(lines, nxt[0]) if nxt is not None and nxt[0] > col else None)
        elif inner == '-' or inner.startswith('- ') or _KEY_RE.match(inner):
            # a nested sequence or a mapping starting on the item's line
            lines.raw[lines.pos] = ' ' * inner_col + inner
            out.append(_node(lines, inner_col))
        else:
            out.append(_scalar(lines, inner, col))


def load(text: str) -> Any:
    '''The value of a YAML document in the subset above.'''
    lines = _Lines(text)
    head = lines.peek()
    if head is None:
        return None
    value = _node(lines, head[0])
    rest = lines.peek()
    if rest is not None:
        raise ValueError(f'unexpected line: {rest[1]!r}')
    return value
