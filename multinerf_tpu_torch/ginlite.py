"""A minimal gin-config-compatible parser (the port's own copy).

Same syntax and semantics as ``multinerf_tpu.ginlite``: ``Target.param =
<literal>`` bindings, ``@name`` references, ``include``, comments and
multi-line bracketed values, unknown targets collected rather than fatal.
The port keeps its own module-global registries, because both packages
register configurables under the same names (``Config``, ``Model``,
``NerfMLP``, ``PropMLP``) bound to different classes.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Any, Dict, List, Optional, Sequence

# target name -> {param name -> value}
_BINDINGS: Dict[str, Dict[str, Any]] = {}
# '@'-reference name -> python object
_EXTERNALS: Dict[str, Any] = {}
# registered configurable classes/functions by name
_CONFIGURABLES: Dict[str, Any] = {}
_SEARCH_PATHS: List[str] = []
_UNKNOWN: List[str] = []


def clear_config():
  """Reset all parsed bindings (not the registries)."""
  _BINDINGS.clear()
  _UNKNOWN.clear()


def add_search_path(path: str):
  if path not in _SEARCH_PATHS:
    _SEARCH_PATHS.append(path)


def register_external(name: str, obj: Any):
  """Make `obj` available to configs as ``@name``."""
  _EXTERNALS[name] = obj


def configurable(cls_or_fn=None, *, name: Optional[str] = None):
  """Register a class/function so configs can bind its parameters."""
  def wrap(obj):
    key = name or obj.__name__
    _CONFIGURABLES[key] = obj
    register_external(key, obj)
    return obj
  if cls_or_fn is None:
    return wrap
  return wrap(cls_or_fn)


def _resolve_ref(name: str) -> Any:
  if name in _EXTERNALS:
    return _EXTERNALS[name]
  # Allow a trailing-module-qualified lookup, e.g. '@foo.bar' when only
  # 'bar' was registered, or '@bar' when 'foo.bar' was.
  short = name.rsplit('.', 1)[-1]
  if short in _EXTERNALS:
    return _EXTERNALS[short]
  for key, val in _EXTERNALS.items():
    if key.rsplit('.', 1)[-1] == name:
      return val
  raise KeyError(f'Unknown gin reference @{name}')


_REF_RE = re.compile(r'@([A-Za-z_][\w.]*)(\(\))?')


def _eval_value(expr: str) -> Any:
  """Evaluate a binding RHS: python literals plus @references."""
  refs: List[Any] = []

  def repl(m):
    obj = _resolve_ref(m.group(1))
    if m.group(2):  # '@ref()' instantiates
      obj = obj()
    refs.append(obj)
    return f'__ref{len(refs) - 1}__'

  substituted = _REF_RE.sub(repl, expr)
  if re.fullmatch(r'__ref0__', substituted.strip()) and len(refs) == 1:
    return refs[0]
  namespace = {f'__ref{i}__': r for i, r in enumerate(refs)}
  try:
    # Literal fast path (no references).
    return ast.literal_eval(substituted)
  except (ValueError, SyntaxError):
    return eval(substituted, {'__builtins__': {}}, namespace)  # noqa: S307


def bind(target: str, param: str, value: Any):
  _BINDINGS.setdefault(target, {})[param] = value


def parse_binding_line(line: str):
  """Parse a single 'Target.param = value' binding."""
  m = re.match(r'^\s*([A-Za-z_][\w]*)\.([\w]+)\s*=\s*(.+)$', line, re.S)
  if not m:
    raise ValueError(f'Cannot parse gin binding: {line!r}')
  target, param, expr = m.groups()
  bind(target, param, _eval_value(expr.strip()))


def _find_config_file(path: str, relative_to: Optional[str]) -> Optional[str]:
  candidates = []
  if os.path.isabs(path):
    candidates.append(path)
  else:
    if relative_to:
      candidates.append(os.path.join(relative_to, path))
    candidates.append(path)
    candidates.extend(os.path.join(sp, path) for sp in _SEARCH_PATHS)
  # Fallback: basename in the including dir / search paths (the reference
  # configs include Google-internal absolute-ish paths that only resolve via
  # gin search paths; mirror that leniency).
  base = os.path.basename(path)
  if relative_to:
    candidates.append(os.path.join(relative_to, base))
  candidates.extend(os.path.join(sp, base) for sp in _SEARCH_PATHS)
  for c in candidates:
    if os.path.exists(c):
      return c
  return None


def _logical_lines(text: str):
  """Yield logical lines, joining continuations inside brackets."""
  buf = ''
  depth = 0
  for raw in text.splitlines():
    line = raw.split('#', 1)[0].rstrip()
    if not line.strip() and depth == 0:
      continue
    buf = (buf + ' ' + line.strip()) if buf else line.strip()
    depth = (buf.count('(') - buf.count(')') +
             buf.count('[') - buf.count(']') +
             buf.count('{') - buf.count('}'))
    if depth <= 0 and buf:
      yield buf
      buf = ''
      depth = 0
  if buf:
    yield buf


def parse_file(path: str):
  """Parse one gin config file (recursively following includes)."""
  with open(path) as f:
    text = f.read()
  here = os.path.dirname(os.path.abspath(path))
  for line in _logical_lines(text):
    m = re.match(r"^include\s+['\"](.+)['\"]$", line)
    if m:
      inc = _find_config_file(m.group(1), here)
      if inc is None:
        _UNKNOWN.append(f'include:{m.group(1)}')
        continue
      parse_file(inc)
      continue
    try:
      parse_binding_line(line)
    except (ValueError, KeyError) as e:
      _UNKNOWN.append(f'{line} ({e})')


def parse_config_files_and_bindings(config_files: Sequence[str] = (),
                                    bindings: Sequence[str] = ()):
  """Entry point equivalent to gin.parse_config_files_and_bindings."""
  for path in config_files or ():
    found = _find_config_file(path, None)
    if found is None:
      raise FileNotFoundError(f'gin config not found: {path}')
    parse_file(found)
  for b in bindings or ():
    parse_binding_line(b)


def get_bindings(target: str) -> Dict[str, Any]:
  """All parsed parameter bindings for a configurable target."""
  return dict(_BINDINGS.get(target, {}))


def apply_bindings(target: str, cls: Any, **overrides) -> Any:
  """Instantiate `cls` with the parsed bindings for `target` (+ overrides).

  Unknown parameter names are dropped with a record in the unknown list
  (gin's skip_unknown semantics).
  """
  kwargs = get_bindings(target)
  if dataclasses.is_dataclass(cls):
    valid = {f.name for f in dataclasses.fields(cls)}
    for k in list(kwargs):
      if k not in valid:
        _UNKNOWN.append(f'{target}.{k}')
        kwargs.pop(k)
  kwargs.update(overrides)
  return cls(**kwargs)


def make(target: str, **overrides) -> Any:
  """Instantiate a registered configurable by name with its bindings."""
  return apply_bindings(target, _CONFIGURABLES[target], **overrides)


def config_str() -> str:
  """Render the resolved config in gin file syntax (for checkpointing)."""
  lines = []
  for target in sorted(_BINDINGS):
    for param, value in sorted(_BINDINGS[target].items()):
      if callable(value):
        name = next((k for k, v in _EXTERNALS.items() if v is value), None)
        rendered = f'@{name}' if name else repr(value)
      else:
        rendered = repr(value)
      lines.append(f'{target}.{param} = {rendered}')
    lines.append('')
  return '\n'.join(lines)


def unknown_bindings() -> List[str]:
  return list(_UNKNOWN)
