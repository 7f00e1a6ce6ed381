"""Config system: YAML + ${...} interpolation + multirun sweeps.

Replaces the reference's Hydra usage (``@hydra.main`` entry points with
``config_dataset.yaml``/``config_simulation.yaml`` pairs and multirun
sweepers; SURVEY.md §2.1 "Config system").  The schema of the YAML files is
kept compatible: ``problem_name``, ``problem_instance``,
``problem_initialpoint``, ``solver_name``, ``solver_option.common`` +
``solver_option.<SOLVER>`` overrides, ``output_path`` with ``${...}``
interpolation, and a ``sweeper.params`` block for multirun.

CLI override grammar (Hydra-like): ``key=value`` (dots for nesting); with
``-m``/``--multirun``, comma-separated values sweep the cross product.

The YAML reader is a small loader for the subset ``configs/*/*.yaml`` use
(nested block maps, inline flow lists, quoted and plain scalars, comments),
resolving plain scalars as PyYAML's ``safe_load`` does (YAML 1.1), so the
package needs no YAML library.
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List

# YAML 1.1 implicit scalar types, as PyYAML's resolver reads them (decimal
# integers only; octal, hex, binary and sexagesimal forms stay strings).
_YAML_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                     "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                     "off", "Off", "OFF"), False),
}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_YAML_INF = re.compile(r"^([-+]?)\.(?:inf|Inf|INF)$")
_YAML_NAN = (".nan", ".NaN", ".NAN")
_DQ_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/", "0": "\0"}


def _plain_scalar(s: str):
    """Resolve an unquoted scalar the way PyYAML's safe_load does."""
    if s in _YAML_NULL:
        return None
    if s in _YAML_BOOL:
        return _YAML_BOOL[s]
    if _YAML_INT.match(s):
        return int(s.replace("_", ""))
    if _YAML_FLOAT.match(s):
        return float(s.replace("_", ""))
    m = _YAML_INF.match(s)
    if m:
        return float(m.group(1) + "inf")
    if s in _YAML_NAN:
        return float("nan")
    return s


def _quoted(s: str, i: int):
    """Quoted scalar starting at s[i] -> (string, index after it)."""
    quote, out, i = s[i], [], i + 1
    while i < len(s):
        ch = s[i]
        if quote == "'" and ch == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and ch == "\\":
            esc = s[i + 1:i + 2]
            if esc not in _DQ_ESCAPES:
                raise ValueError(f"unsupported YAML escape \\{esc} in {s!r}")
            out.append(_DQ_ESCAPES[esc])
            i += 2
            continue
        if quote == '"' and ch == '"':
            return "".join(out), i + 1
        out.append(ch)
        i += 1
    raise ValueError(f"unterminated quoted YAML scalar: {s!r}")


def _flow_value(s: str, i: int = 0, in_flow: bool = False):
    """Scalar or inline ``[...]`` list starting at s[i] -> (value, index)."""
    while i < len(s) and s[i] == " ":
        i += 1
    if s[i:i + 1] == "[":
        items, i = [], i + 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if s[i:i + 1] == "]":
                return items, i + 1
            item, i = _flow_value(s, i, in_flow=True)
            items.append(item)
            while i < len(s) and s[i] == " ":
                i += 1
            if s[i:i + 1] == ",":
                i += 1
            elif s[i:i + 1] != "]":
                raise ValueError(f"malformed YAML flow list: {s!r}")
    if s[i:i + 1] in ("'", '"'):
        return _quoted(s, i)
    if s[i:i + 1] and s[i] in "{&*!|>%@`":
        raise ValueError(f"YAML construct outside the supported subset: {s!r}")
    j = i
    while j < len(s) and not (in_flow and s[j] in ",[]{}"):
        j += 1
    return _plain_scalar(s[i:j].strip()), j


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_key(text: str):
    """``key: rest`` -> (key, rest); the colon must end the line or be
    followed by a space, outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == ":" and text[i + 1:i + 2] in ("", " "):
            key = text[:i].strip()
            key = _quoted(key, 0)[0] if key[:1] in ("'", '"') else _plain_scalar(key)
            return key, text[i + 1:].strip()
    raise ValueError(f"expected 'key: value' in YAML line {text!r}")


def _block_map(lines, i: int, indent: int):
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][0] == indent:
        key, rest = _split_key(lines[i][1])
        i += 1
        if rest:
            value, end = _flow_value(rest)
            if rest[end:].strip():
                raise ValueError(f"trailing text in YAML value {rest!r}")
            out[key] = value
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _block_map(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"unexpected indentation in YAML line {lines[i][1]!r}")
    return out, i


def yaml_load(text: str):
    """Parse the YAML subset of ``configs/*/*.yaml`` (see module doc);
    anything outside it raises ValueError.  Empty input gives None, as in
    PyYAML."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith(("\t", "- ", "{", "---", "...")) or body == "-":
            raise ValueError(f"YAML construct outside the supported subset: {raw!r}")
        lines.append((len(line) - len(body), body))
    if not lines:
        return None
    value, i = _block_map(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation in YAML line {lines[i][1]!r}")
    return value


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(dict):
    """Dict with attribute access (cfg.problem_name) and nested lookup."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        cur = self
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = value


_NUMBER = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _coerce(value):
    """PyYAML (YAML 1.1) reads '1e-2' as a string; coerce numeric-looking
    strings to numbers, recursively (what OmegaConf/Hydra do)."""
    if isinstance(value, str) and _NUMBER.match(value):
        f = float(value)
        return int(f) if f.is_integer() and ("e" not in value.lower() and "." not in value) else f
    if isinstance(value, dict):
        return {k: _coerce(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_coerce(v) for v in value]
    return value


def _parse_scalar(s: str):
    """YAML-ish scalar parsing for CLI override values."""
    s = _strip_comment(s).strip()
    value, end = _flow_value(s)
    if s[end:].strip():
        raise ValueError(f"cannot parse override value {s!r}")
    return _coerce(value)


def _interpolate(value, root: Config):
    if isinstance(value, str):
        def repl(match):
            v = root.get_path(match.group(1))
            return str(v) if v is not None else match.group(0)

        # full-string reference keeps native type
        m = _INTERP.fullmatch(value)
        if m is not None:
            v = root.get_path(m.group(1))
            return v if v is not None else value
        return _INTERP.sub(repl, value)
    if isinstance(value, dict):
        return {k: _interpolate(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_interpolate(v, root) for v in value]
    return value


def load_config(
    path: str, overrides: List[str] | None = None, interpolate: bool = True
) -> Config:
    with open(path) as f:
        raw = _coerce(yaml_load(f.read()) or {})
    cfg = Config(raw)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must be key=value")
        k, v = ov.split("=", 1)
        cfg.set_path(k, _parse_scalar(v))
    if not interpolate:
        return cfg
    return Config(_interpolate(cfg, cfg))


def sweep_configs(path: str, overrides: List[str] | None = None) -> List[Config]:
    """Expand the multirun cross product.

    Sweep axes come from the config's ``sweeper.params`` block (also
    accepted under ``hydra.sweeper.params`` for schema compatibility),
    overridden/extended by comma-separated CLI overrides.  Matches the
    reference protocol of sweeping instance x initial point x solver
    (``README.md:72-107``).
    """
    with open(path) as f:
        raw = yaml_load(f.read()) or {}
    base = Config(raw)
    params: Dict[str, list] = {}
    sweeper = base.get_path("sweeper.params") or base.get_path("hydra.sweeper.params") or {}
    for k, v in dict(sweeper).items():
        if isinstance(v, str):
            params[k] = [_parse_scalar(x) for x in v.split(",")]
        elif isinstance(v, list):
            params[k] = [v]  # a literal list value is a single choice
        else:
            params[k] = [v]
    scalar_overrides = []
    for ov in overrides or []:
        k, v = ov.split("=", 1)
        if "," in v and not v.strip().startswith("["):
            params[k] = [_parse_scalar(x) for x in v.split(",")]
        elif k in params:
            # Single-value override of a sweep axis PINS it (Hydra
            # semantics): without this the per-combo set_path would clobber
            # the override with every sweep value.
            params[k] = [_parse_scalar(v)]
        else:
            scalar_overrides.append(ov)

    if not params:
        return [load_config(path, scalar_overrides)]
    keys = sorted(params)
    configs = []
    for combo in itertools.product(*(params[k] for k in keys)):
        # Interpolation must happen AFTER the sweep values are applied, or
        # ${problem_initialpoint}-style paths freeze at their defaults and
        # every job writes to the same directory.
        cfg = load_config(path, scalar_overrides, interpolate=False)
        for k, v in zip(keys, combo):
            cfg.set_path(k, v)
        configs.append(Config(_interpolate(cfg, cfg)))
    return configs


def solver_options_from_cfg(cfg: Config, solver_name: str) -> dict:
    """common <- solver-specific merge (``base_simulator.py:51-67``)."""
    so = cfg.get_path("solver_option") or {}
    option = dict(so.get("common", {}))
    option.update(so.get(solver_name, {}))
    return option


def maybe_help(argv, doc):
    """Shared -h/--help handling for the hand-rolled experiment CLIs."""
    if any(a in ("-h", "--help") for a in argv):
        print(doc)
        raise SystemExit(0)
