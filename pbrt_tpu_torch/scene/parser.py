""".pbrt scene-description parser (port of pbrt_tpu/scene/parser.py): a
hand-rolled tokenizer and a directive loop that drives the Api."""
from __future__ import annotations

import logging
import os
import re
from typing import List

from pbrt_tpu_torch.scene.paramset import ParamSet, ALL_TYPES

_TOKEN_RE = re.compile(r"""
    "(?:[^"\\]|\\.)*"      # quoted string
  | \[ | \]
  | [^\s"\[\]\#]+          # bare token (number / directive)
  | \#[^\n]*               # comment
""", re.VERBOSE)

_NUMERIC_ARGS = {
    "Translate": 3, "Scale": 3, "Rotate": 4, "LookAt": 9,
    "Transform": 16, "ConcatTransform": 16, "TransformTimes": 2,
}
_TYPED_WITH_PARAMS = {
    "Camera", "Sampler", "Film", "PixelFilter", "Filter", "Integrator",
    "Accelerator", "Shape", "Material", "MakeNamedMaterial", "LightSource",
    "AreaLightSource", "MakeNamedMedium", "Option",
}
_NAME_ONLY = {"NamedMaterial", "ObjectBegin", "ObjectInstance",
              "CoordinateSystem", "CoordSysTransform", "Include", "Import",
              "ActiveTransform"}
_BARE = {"AttributeBegin", "AttributeEnd", "TransformBegin", "TransformEnd",
         "ObjectEnd", "WorldBegin", "WorldEnd", "ReverseOrientation",
         "Identity"}


def tokenize(text: str) -> List[str]:
    return [t for t in (m.group(0) for m in _TOKEN_RE.finditer(text))
            if not t.startswith("#")]


def _is_quoted(t: str) -> bool:
    return t.startswith('"')


def _unquote(t: str) -> str:
    return t[1:-1] if _is_quoted(t) else t


class _Stream:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def done(self):
        return self.i >= len(self.toks)


def _parse_params(s: _Stream, cwd: str) -> ParamSet:
    """Consume '"type name" [values]' groups until the next directive."""
    ps = ParamSet()
    while not s.done():
        t = s.peek()
        if not _is_quoted(t):
            break
        decl = _unquote(t).split()
        if len(decl) != 2 or decl[0] not in ALL_TYPES:
            break
        s.next()
        ptype, name = decl
        vals = []
        if s.peek() == "[":
            s.next()
            while s.peek() != "]":
                tok = s.next()
                vals.append(_unquote(tok))
            s.next()
        else:
            vals.append(_unquote(s.next()))
        ps.declare(ptype, name, vals, cwd)
    return ps


def parse_tokens(tokens: List[str], api, cwd: str = "."):
    s = _Stream(tokens)
    while not s.done():
        d = s.next()
        if _is_quoted(d):
            raise SyntaxError(f"unexpected string {d} at top level")
        if d in _BARE:
            getattr(api, _snake(d))()
        elif d in _NUMERIC_ARGS:
            args = [float(s.next()) for _ in range(_NUMERIC_ARGS[d])]
            getattr(api, _snake(d))(*args)
        elif d in ("Include", "Import"):
            path = _unquote(s.next())
            full = path if os.path.isabs(path) else os.path.join(cwd, path)
            if os.path.exists(full):
                parse_file(full, api)
            else:
                logging.getLogger(__name__).warning("Include not found: %s", full)
        elif d == "Texture":
            name = _unquote(s.next())
            ttype = _unquote(s.next())
            tclass = _unquote(s.next())
            api.texture(name, ttype, tclass, _parse_params(s, cwd))
        elif d == "MediumInterface":
            inside = _unquote(s.next())
            outside = _unquote(s.next()) if (s.peek() and _is_quoted(s.peek())) else ""
            api.medium_interface(inside, outside)
        elif d == "ActiveTransform":
            api.active_transform(s.next())
        elif d in _NAME_ONLY:
            getattr(api, _snake(d))(_unquote(s.next()))
        elif d in _TYPED_WITH_PARAMS:
            name = _unquote(s.next())
            ps = _parse_params(s, cwd)
            getattr(api, "pixel_filter" if d == "Filter" else _snake(d))(name, ps)
        else:
            raise SyntaxError(f"unknown directive {d!r}")


_SNAKE_RE = re.compile(r"(?<!^)(?=[A-Z])")


def _snake(name: str) -> str:
    return _SNAKE_RE.sub("_", name).lower()


def parse_file(path: str, api):
    with open(path, "r") as f:
        text = f.read()
    parse_tokens(tokenize(text), api, cwd=os.path.dirname(os.path.abspath(path)))


def parse_string(text: str, api, cwd: str = "."):
    parse_tokens(tokenize(text), api, cwd=cwd)
