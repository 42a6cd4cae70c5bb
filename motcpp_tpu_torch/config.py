"""YAML tracker configuration, read without PyYAML.

Counterpart of ``motcpp_tpu/config.py`` (reference:
include/motcpp/config.hpp:16-49, src/config.cpp:12-80): YAML files under
``configs/trackers/<name>.yaml`` are parsed into a typed parameter map
with two node styles:

  * flat scalars:            ``det_thresh: 0.2``
  * hyperparameter nodes:    ``{type: uniform|choice|randint,
                               default: ..., range|choices: ...}``
    where loading takes the ``default`` and the range doubles as a
    tuning search space (src/config.cpp:24-49).

The JAX package reads the files with ``yaml.safe_load``. This module has
its own reader, :func:`parse_yaml`, for the subset of YAML the configs
use, and resolves each plain scalar as ``yaml.safe_load`` (YAML 1.1)
does. Anything outside the subset raises ``ValueError``: the reader
never guesses what a line means.
"""

from __future__ import annotations

import re
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs" / "trackers"

# --------------------------------------------------------------- scalars
# PyYAML's implicit resolvers for plain scalars (YAML 1.1), cut to the
# forms the subset constructs, in the order PyYAML tries them; the first
# that matches decides the type.
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|"
                   r"FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$""", re.X)
_INT = re.compile(r"^(?:[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# what PyYAML would construct as something the subset does not: binary,
# octal and sexagesimal numbers, infinities and NaN, merge keys,
# timestamps and values
_REFUSED = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN)
    |<<
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?
    |=)$""", re.X)
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_\-]*$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _resolve(text: str):
    """A plain scalar as ``yaml.safe_load`` constructs it."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        return sign * (int(v[2:], 16) if v.startswith("0x") else int(v))
    if _NULL.match(text):
        return None
    if _REFUSED.match(text):
        raise ValueError(f"scalar {text!r} is outside the YAML subset "
                         "(binary, octal or sexagesimal number, .inf, "
                         ".nan, merge key, timestamp or value)")
    return text


def _quoted(text: str, where: str):
    """A single- or double-quoted scalar at the start of ``text``; returns
    the string and the rest of ``text`` after the closing quote."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        c = text[i]
        if c == quote:
            if quote == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if c == "\\" and quote == '"':
            e = text[i + 1:i + 2]
            if e not in _ESCAPES:
                raise ValueError(f"{where}: an escape outside the YAML "
                                 f"subset in {text!r}")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"{where}: unterminated or multi-line quoted scalar")


def _strip_comment(rest: str, where: str) -> str:
    """What follows a complete scalar must be blank or a comment that a
    space or tab separates from it."""
    if rest.strip() and not re.match(r"^[ \t]+#", rest):
        raise ValueError(f"{where}: unexpected text {rest.strip()!r} "
                         "after a scalar")
    return ""


def _plain(text: str, where: str, flow: bool):
    """A plain scalar: up to a comment (and, in a flow list, up to a
    comma or the closing bracket)."""
    if text[:1] in "#&*!|>%@`{}]," or text[:2] in ("- ", "? ") \
            or text in ("-", "?"):
        raise ValueError(f"{where}: {text!r} is outside the YAML subset "
                         "(anchor, alias, tag, block scalar, block list, "
                         "flow mapping or reserved indicator)")
    m = re.search(r"[ \t]#", text)
    body = text[:m.start()] if m else text
    stop = re.search(r"[,\]\[{}]", body) if flow else None
    rest = ""
    if stop:
        body, rest = body[:stop.start()], body[stop.start():]
    elif m:
        rest = text[m.start():]
    body = body.rstrip(" \t")
    if re.search(r":([ \t]|$)", body) or body.endswith(":"):
        raise ValueError(f"{where}: a mapping inside the value {text!r}")
    return _resolve(body), rest


def _flow_list(text: str, where: str):
    """A one-line flow list ``[a, b, "c"]`` of scalars; returns the list
    and the rest of the line."""
    items, rest = [], text[1:].lstrip(" \t")
    if rest.startswith("]"):
        return items, rest[1:]
    while True:
        if not rest:
            raise ValueError(f"{where}: unterminated or multi-line flow list")
        if rest[0] in "'\"":
            item, rest = _quoted(rest, where)
        elif rest[0] in "[{":
            raise ValueError(f"{where}: nested flow collections are outside "
                             "the YAML subset")
        else:
            item, rest = _plain(rest, where, flow=True)
        items.append(item)
        rest = rest.lstrip(" \t")
        if rest.startswith("]"):
            return items, rest[1:]
        if not rest.startswith(","):
            raise ValueError(f"{where}: expected ',' or ']' in a flow list")
        rest = rest[1:].lstrip(" \t")
        if rest.startswith("]"):
            raise ValueError(f"{where}: a trailing comma in a flow list")


def _value(text: str, where: str):
    """The value after ``key:`` on one line (scalar or flow list)."""
    text = text.lstrip(" \t")
    if text[:1] == "[":
        value, rest = _flow_list(text, where)
    elif text[:1] in "'\"":
        value, rest = _quoted(text, where)
    else:
        value, rest = _plain(text, where, flow=False)
    _strip_comment(rest, where)
    return value


def _key_value(line: str, where: str):
    """``key: value`` -> (key, value text); the key is a plain word."""
    m = re.match(r"^([^:#'\"]*?)[ \t]*:(?:[ \t]+|$)", line)
    if not m or not _KEY.match(m.group(1)):
        raise ValueError(f"{where}: {line.strip()!r} is not a 'key: value' "
                         "line of the YAML subset")
    return _resolve(m.group(1)), line[m.end():]


def parse_yaml(text: str):
    """Parse the YAML subset of ``configs/trackers/*.yaml``.

    The subset: comments (whole-line and inline), top-level ``key:
    scalar`` lines, and ``key:`` followed by one indented level of
    ``key: scalar`` lines; scalars plain, single- or double-quoted, or
    one-line flow lists of scalars; one optional leading ``---``.
    Returns what ``yaml.safe_load`` returns for the same text (a dict,
    or None for an empty document). Anything else (anchors and aliases,
    tags, block lists and block scalars, flow mappings, deeper nesting,
    multi-line scalars, a second document, duplicate keys, tabs in the
    indentation, carriage returns, numbers PyYAML reads as binary,
    octal, sexagesimal, infinite or NaN, escapes beyond the basic
    ones) raises ValueError.
    """
    if "\r" in text or "\ufeff" in text:
        raise ValueError("a carriage return or byte order mark is outside "
                         "the YAML subset")
    out: dict = {}
    node = None  # the nested mapping being filled, and its indent
    indent = None
    seen_content = False
    for n, line in enumerate(text.split("\n"), 1):
        where = f"line {n}"
        body = line.rstrip(" \t")
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        lead = len(body) - len(stripped)
        if stripped.startswith("\t") or "\t" in body[:lead]:
            raise ValueError(f"{where}: a tab in the indentation")
        if body.startswith("---") and body[3:4] in ("", " ", "\t"):
            if seen_content or body[3:].strip() and \
                    not body[3:].lstrip().startswith("#"):
                raise ValueError(f"{where}: a second document or content "
                                 "after '---' is outside the YAML subset")
            seen_content = True
            continue
        if body.startswith(("...", "%")):
            raise ValueError(f"{where}: directives and document end markers "
                             "are outside the YAML subset")
        seen_content = True
        if lead == 0:
            key, rest = _key_value(body, where)
            if key in out:
                raise ValueError(f"{where}: duplicate key {key!r}")
            rest_is_empty = not rest.strip() or rest.lstrip().startswith("#")
            if rest_is_empty:
                out[key] = None  # a nested mapping may follow
                node, indent = key, None
            else:
                out[key] = _value(rest, where)
                node = None
            continue
        if node is None:
            raise ValueError(f"{where}: an indented line that continues a "
                             "scalar or nests deeper than one level")
        if indent is None:
            indent = lead
            out[node] = {}
        elif lead != indent:
            raise ValueError(f"{where}: nesting deeper than one level (or "
                             "uneven indentation)")
        key, rest = _key_value(stripped, where)
        if key in out[node]:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if not rest.strip() or rest.lstrip().startswith("#"):
            out[node][key] = None
            # a third level would follow here; the next line rejects it
            continue
        out[node][key] = _value(rest, where)
    return out or None


# --------------------------------------------------------------- config
class TrackerConfig:
    """Typed accessor map (reference: config.hpp:22-44)."""

    def __init__(self, params: dict | None = None,
                 search_space: dict | None = None):
        self.params = params or {}
        self.search_space = search_space or {}

    def get_float(self, key: str, default: float = 0.0) -> float:
        return float(self.params.get(key, default))

    def get_int(self, key: str, default: int = 0) -> int:
        return int(self.params.get(key, default))

    def get_bool(self, key: str, default: bool = False) -> bool:
        return bool(self.params.get(key, default))

    def get_string(self, key: str, default: str = "") -> str:
        return str(self.params.get(key, default))

    def as_kwargs(self) -> dict:
        return dict(self.params)

    def sample(self, rng) -> dict:
        """Draw one parameter set from the search space with numpy
        Generator ``rng``; non-search params pass through unchanged.

        Node semantics (reference: src/config.cpp:24-49):
          * ``uniform``: float in [lo, hi]
          * ``randint``: int from lo..hi (exclusive) with optional step
            (``range: [10, 61, 10]`` -> 10, 20, ..., 60)
          * ``choice``: one of the listed values
        """
        out = dict(self.params)
        for key, node in self.search_space.items():
            kind = node.get("type")
            rng_spec = node.get("range")
            if kind == "uniform":
                lo, hi = float(rng_spec[0]), float(rng_spec[1])
                out[key] = float(rng.uniform(lo, hi))
            elif kind == "randint":
                lo, hi = int(rng_spec[0]), int(rng_spec[1])
                step = int(rng_spec[2]) if len(rng_spec) > 2 else 1
                choices = list(range(lo, hi, step))
                out[key] = int(choices[rng.integers(len(choices))])
            elif kind == "choice":
                out[key] = rng_spec[int(rng.integers(len(rng_spec)))]
            else:
                raise ValueError(f"unknown search node type {kind!r} for {key}")
        return out


def get_tracker_config_path(name: str) -> Path:
    """name -> configs/trackers/<name>.yaml (src/config.cpp:76-80)."""
    return CONFIG_DIR / f"{name}.yaml"


def load_tracker_config(path_or_name) -> TrackerConfig:
    """Load a tracker YAML; accepts a path or a tracker name."""
    path = Path(path_or_name)
    if not path.exists():
        path = get_tracker_config_path(str(path_or_name))
    if not path.exists():
        raise FileNotFoundError(f"Tracker config not found: {path_or_name}")
    raw = parse_yaml(path.read_text()) or {}

    params: dict = {}
    search: dict = {}
    for key, node in raw.items():
        if isinstance(node, dict) and "type" in node:
            # hyperparameter-search node: take the default value
            params[key] = node.get("default")
            search[key] = {
                "type": node.get("type"),
                "range": node.get("range", node.get("choices")),
            }
        else:
            params[key] = node
    return TrackerConfig(params, search)
