"""Config and flag system (counterpart of neumesh_tpu/config.py).

- ``ConfigDict``: attribute-style nested dict that RAISES on missing keys
  while still supporting ``setdefault``/``get``, so builder defaults
  double as schema.
- A reader and writer for the YAML subset the repository's configs use
  (the card machine has no PyYAML, so this is the only YAML path):
  nested block maps; block and flow lists of scalars; int, float, bool,
  null/``~`` and quoted strings resolved as PyYAML's safe loader resolves
  them (YAML 1.1: ``1e-5`` without a dot stays a string, ``yes``/``on``
  are booleans); ``{}`` and ``[]``; comments. Anything else (anchors,
  aliases, tags, multi-line or block scalars, flow maps, lists of maps,
  timestamps) raises with its line number.
- CLI overrides ``--section:key value`` (and ``--key value``), values
  coerced against the existing config value.
- ``load_config``: CLI > --config yaml > defaults; ``--resume_dir``
  reloads an experiment's saved config.yaml.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
from typing import Any, Optional


class ConfigDict(dict):
    """Nested dict with attribute access; missing keys raise KeyError."""

    def __init__(self, d: Optional[dict] = None, **kwargs):
        super().__init__()
        for src in (d or {}, kwargs):
            for k, v in src.items():
                self[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise KeyError(f"missing config key: {name!r}") from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __setitem__(self, name, value):
        super().__setitem__(name, _wrap(value))

    def __delattr__(self, name: str) -> None:
        del self[name]

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]

    def get(self, key, default=None):
        if key in self:
            return self[key]
        return _wrap(default)

    def to_dict(self) -> dict:
        return _unwrap(self)

    def copy(self) -> "ConfigDict":
        return ConfigDict(self.to_dict())


def _wrap(v):
    if isinstance(v, dict) and not isinstance(v, ConfigDict):
        return ConfigDict(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_wrap(x) for x in v)
    return v


def _unwrap(v):
    if isinstance(v, dict):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_unwrap(x) for x in v]
    return v


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

class YAMLSubsetError(ValueError):
    """Input outside the YAML subset this reader accepts."""


# PyYAML's implicit resolvers (YAML 1.1), sexagesimal forms left out
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True, "no": False,
         "No": False, "NO": False, "false": False, "False": False,
         "FALSE": False, "off": False, "Off": False, "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                        r"|[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_FLOAT_OTHER = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_PLAIN_BAD_START = set("&*!|>%@`{[]},'\"#")


def _scalar(s: str, line: int):
    """One scalar token (already stripped of comments and whitespace)."""
    if s[:1] in ("'", '"'):
        return _quoted(s, line)
    if s[:1] in _PLAIN_BAD_START or s.startswith("- ") or s == "-" \
            or s.startswith("<<") or ": " in s or s.endswith(":"):
        raise YAMLSubsetError(f"line {line}: unsupported YAML {s!r}")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    m = _INF.match(s)
    if m:
        return -math.inf if m.group(1) == "-" else math.inf
    if _NAN.match(s):
        return math.nan
    if _INT_OTHER.match(s) or _FLOAT_OTHER.match(s) or _TIMESTAMP.match(s) \
            or s == "=":
        raise YAMLSubsetError(f"line {line}: unsupported YAML scalar {s!r}")
    return s


def _quoted(s: str, line: int) -> str:
    q = s[0]
    if len(s) < 2 or s[-1] != q:
        raise YAMLSubsetError(f"line {line}: unterminated or multi-line "
                              f"quoted string {s!r}")
    body = s[1:-1]
    if q == "'":
        if re.search(r"(?<!')'(?!')", body.replace("''", "")):
            raise YAMLSubsetError(f"line {line}: bad quoted string {s!r}")
        return body.replace("''", "'")
    try:
        return json.loads(s)
    except ValueError as e:
        raise YAMLSubsetError(
            f"line {line}: unsupported escape in {s!r}") from e


def _split_flow(body: str, line: int):
    """Top-level comma split of a flow list body, quotes respected."""
    items, cur, q = [], "", None
    for ch in body:
        if q:
            cur += ch
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            cur += ch
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        elif ch in "[]{}":
            raise YAMLSubsetError(f"line {line}: nested flow collections "
                                  "are not supported")
        else:
            cur += ch
    if q:
        raise YAMLSubsetError(f"line {line}: unterminated quoted string")
    items.append(cur.strip())
    if items[-1] == "":
        items.pop()
    if any(i == "" for i in items):
        raise YAMLSubsetError(f"line {line}: empty flow list item")
    return items


def _value(s: str, line: int):
    """A scalar, a flow list of scalars, or an empty flow map."""
    if s.startswith("["):
        if not s.endswith("]"):
            raise YAMLSubsetError(f"line {line}: multi-line flow list")
        return [_scalar(i, line) for i in _split_flow(s[1:-1], line)]
    if s.startswith("{"):
        if s.replace(" ", "") != "{}":
            raise YAMLSubsetError(f"line {line}: flow maps are not supported")
        return {}
    return _scalar(s, line)


def _strip_comment(text: str) -> str:
    q = None
    for i, ch in enumerate(text):
        if q:
            if ch == q:
                q = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t:[,-"):
            q = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _split_key(content: str, line: int):
    """'key: rest' -> (key, rest) or None when content is no mapping."""
    if content[:1] in ("'", '"'):
        end = content.find(content[0], 1)
        while content[0] == "'" and end + 1 < len(content) \
                and content[end + 1] == "'":
            end = content.find("'", end + 2)
        if end < 0:
            raise YAMLSubsetError(f"line {line}: unterminated quoted key")
        rest = content[end + 1:]
        if not (rest == ":" or rest.startswith(": ")):
            return None
        return _quoted(content[:end + 1], line), rest[1:].strip()
    m = re.match(r"([^#'\"\[\]{},][^#]*?):(?: +(.*))?$", content)
    if m is None:
        return None
    return _scalar(m.group(1).strip(), line), (m.group(2) or "").strip()


def parse_yaml(text: str, where: str = "<yaml>"):
    """Parse `text` in the YAML subset of this module's docstring."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        body = raw.rstrip("\n")
        if "\t" in body[:len(body) - len(body.lstrip(" \t"))]:
            raise YAMLSubsetError(f"{where}: line {n}: tab indentation")
        content = _strip_comment(body.strip())
        if not content:
            continue
        if content in ("---", "...") or content.startswith("%"):
            raise YAMLSubsetError(f"{where}: line {n}: documents and "
                                  "directives are not supported")
        lines.append((len(body) - len(body.lstrip(" ")), content, n))
    if not lines:
        return None
    try:
        val, i = _block(lines, 0, lines[0][0])
        if i < len(lines):
            raise YAMLSubsetError(f"line {lines[i][2]}: unexpected "
                                  "indentation")
    except YAMLSubsetError as e:
        raise YAMLSubsetError(f"{where}: {e}") from None
    return val


def _block(lines, i, indent):
    content = lines[i][1]
    if content == "-" or content.startswith("- "):
        return _block_list(lines, i, indent)
    if _split_key(content, lines[i][2]) is None:
        if len(lines) > i + 1 and lines[i + 1][0] >= indent:
            raise YAMLSubsetError(f"line {lines[i + 1][2]}: multi-line "
                                  "scalars are not supported")
        return _value(content, lines[i][2]), i + 1
    return _block_map(lines, i, indent)


def _block_list(lines, i, indent):
    out = []
    while i < len(lines) and lines[i][0] == indent:
        ind, content, n = lines[i]
        if not (content == "-" or content.startswith("- ")):
            break
        item = content[1:].strip()
        if not item:
            raise YAMLSubsetError(f"line {n}: nested block in a list is "
                                  "not supported")
        if _split_key(item, n) is not None:
            raise YAMLSubsetError(f"line {n}: lists of maps are not "
                                  "supported")
        out.append(_value(item, n))
        i += 1
        if i < len(lines) and lines[i][0] > indent:
            raise YAMLSubsetError(f"line {lines[i][2]}: multi-line list "
                                  "items are not supported")
    return out, i


def _block_map(lines, i, indent):
    out = {}
    while i < len(lines) and lines[i][0] >= indent:
        ind, content, n = lines[i]
        if ind > indent:
            raise YAMLSubsetError(f"line {n}: unexpected indentation")
        kv = _split_key(content, n)
        if kv is None:
            raise YAMLSubsetError(f"line {n}: expected 'key: value', got "
                                  f"{content!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _value(rest, n)
            if i < len(lines) and lines[i][0] > indent:
                raise YAMLSubsetError(f"line {lines[i][2]}: multi-line "
                                      "scalars are not supported")
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and (lines[i][1] == "-"
                                           or lines[i][1].startswith("- ")))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r and "." not in r.split("e")[0]:
            m, e = r.split("e")
            r = f"{m}.0e{e}"
        if "e" in r and r.split("e")[1][0] not in "+-":
            r = r.replace("e", "e+")
        return r
    if isinstance(v, str):
        try:
            plain = _scalar(v, 0) == v and v == v.strip() and "#" not in v
        except YAMLSubsetError:
            plain = False
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} as YAML")


def dump_yaml(data: dict) -> str:
    """Block-style YAML of nested dicts, lists of scalars and scalars that
    parse_yaml (and PyYAML) read back as `data`."""
    out = []

    def emit(d, pad):
        for k, v in d.items():
            key = _dump_scalar(k)
            if isinstance(v, dict) and v:
                out.append(f"{pad}{key}:")
                emit(v, pad + "  ")
            elif isinstance(v, dict):
                out.append(f"{pad}{key}: {{}}")
            elif isinstance(v, (list, tuple)):
                out.append(f"{pad}{key}: ["
                           + ", ".join(_dump_scalar(x) for x in v) + "]")
            else:
                out.append(f"{pad}{key}: {_dump_scalar(v)}")
    emit(_unwrap(data), "")
    return "\n".join(out) + "\n"


def load_yaml(path: str, default_path: Optional[str] = None) -> ConfigDict:
    with open(path, "r", encoding="utf8") as f:
        config = ConfigDict(parse_yaml(f.read(), path) or {})
    if default_path is not None and path != default_path:
        with open(default_path, "r", encoding="utf8") as f:
            default = ConfigDict(parse_yaml(f.read(), default_path) or {})
        _merge_into(default, config)
        return default
    return config


def save_yaml(config, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        f.write(dump_yaml(config))


def _merge_into(dst: ConfigDict, src: dict) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge_into(dst[k], v)
        else:
            dst[k] = v


def _coerce(new_str: str, old_value: Any) -> Any:
    """Coerce a CLI string to the type of the existing config value."""
    if isinstance(old_value, bool):
        return new_str.lower() in ("1", "true", "yes", "on")
    if isinstance(old_value, int):
        return int(new_str)
    if isinstance(old_value, float):
        return float(new_str)
    if isinstance(old_value, (list, tuple)) or old_value is None:
        # a list, or an unknown target type: the YAML reader guesses
        return parse_yaml(new_str, "override")
    return new_str


def update_config(config: ConfigDict, unknown: list) -> ConfigDict:
    """Apply ``--section:key value`` / ``--key value`` overrides in place."""
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        if not tok.startswith("--"):
            i += 1
            continue
        if "=" in tok:
            keypath, val = tok[2:].split("=", 1)
            i += 1
        else:
            keypath = tok[2:]
            if i + 1 >= len(unknown):
                raise ValueError(f"missing value for override {tok}")
            val = unknown[i + 1]
            i += 2
        keys = keypath.split(":")
        node = config
        for k in keys[:-1]:
            if k not in node:
                node[k] = ConfigDict()
            node = node[k]
        old = node[keys[-1]] if keys[-1] in node else None
        node[keys[-1]] = _coerce(val, old)
    return config


def create_args_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config", type=str, default=None, help="config yaml")
    parser.add_argument(
        "--resume_dir", type=str, default=None,
        help="experiment dir to resume from (reloads its config.yaml)")
    return parser


def load_config(args, unknown: Optional[list] = None,
                base_config_path: Optional[str] = None) -> ConfigDict:
    """CLI > --config yaml > base defaults; or resume from saved config."""
    unknown = unknown or []
    if getattr(args, "resume_dir", None) is not None:
        if getattr(args, "config", None) is not None:
            raise ValueError("given --resume_dir, do not set --config")
        config = load_yaml(os.path.join(args.resume_dir, "config.yaml"))
        config.training.exp_dir = args.resume_dir
    else:
        if getattr(args, "config", None) is None:
            raise ValueError("--config is required")
        config = load_yaml(args.config, default_path=base_config_path)

    update_config(config, unknown)

    # copy plain argparse entries into the config (CLI wins)
    for k, v in vars(args).items():
        if k in ("config", "resume_dir"):
            continue
        if v is not None or k not in config:
            config[k] = v

    config.setdefault("device_ids", [0])
    config.setdefault("ddp", False)
    return config


def backup_sources(backup_dir: str, source_root: str = ".") -> None:
    """Snapshot the .py / .yaml / .json files under source_root into the
    experiment directory (hidden directories, caches, logs, outputs, data
    and build trees are skipped)."""
    import shutil

    skip = ("__pycache__", "logs", "out", "data", "node_modules", "build")
    backup_dir = os.path.abspath(backup_dir)
    os.makedirs(backup_dir, exist_ok=True)
    for dirpath, dirnames, filenames in os.walk(source_root):
        dirnames[:] = [d for d in dirnames
                       if d not in skip and not d.startswith(".")
                       and os.path.abspath(os.path.join(dirpath, d))
                       != backup_dir]
        for fn in filenames:
            if fn.endswith((".py", ".yaml", ".json")):
                src = os.path.join(dirpath, fn)
                dst = os.path.join(backup_dir,
                                   os.path.relpath(src, source_root))
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                try:
                    shutil.copy2(src, dst)
                except OSError:
                    pass
