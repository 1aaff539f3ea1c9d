"""Text-format scene description parser (.luisa files).

Counterpart of luisarender_tpu/scene/text_parser.py, kept as the port's own
copy: the text SDL with `import "file"`, `define KEY value` / `#macro`
substitution with caller overrides, global nodes `Tag name : impl(base)
{ props }`, the root node `render { ... }`, inline nodes `prop : impl
{ ... }`, `@name` references, value lists `{ a, b, c }`, and `//`
comments. Imports are parsed eagerly, in the order they appear."""

from __future__ import annotations

from pathlib import Path

from .node import SceneNodeError, SceneNodeTag, parse_scene_node_tag
from .parser import ROOT_NODE_IDENTIFIER, SceneDesc


class _TextParser:
    def __init__(self, desc: SceneDesc, path: Path, macros: dict):
        self.desc = desc
        self.path = Path(path)
        self.macros = dict(macros)
        with open(path, "r") as f:
            self.src = f.read().replace("\r\n", "\n")
        self.pos = 0
        self.pending: list[str] = []  # macro-expansion character stack

    # --- character stream with macro expansion ---
    def _eof(self):
        return not self.pending and self.pos >= len(self.src)

    def _raw_peek(self):
        if self.pending:
            return self.pending[-1]
        if self.pos >= len(self.src):
            raise SceneNodeError(f"{self.path}: premature EOF")
        return self.src[self.pos]

    def _raw_get(self):
        c = self._raw_peek()
        if self.pending:
            self.pending.pop()
        else:
            self.pos += 1
        return c

    def peek(self, escape_macro=False):
        c = self._raw_peek()
        while c == "#" and not escape_macro:
            self._raw_get()
            self._expand_macro()
            c = self._raw_peek()
        return c

    def get(self, escape_macro=False):
        c = self._raw_get()
        while c == "#" and not escape_macro:
            self._expand_macro()
            c = self._raw_get()
        return c

    def _expand_macro(self):
        name = self.read_identifier(escape_macro=True)
        if name not in self.macros:
            raise SceneNodeError(f"{self.path}: undefined macro '#{name}'")
        self.pending.extend(reversed(self.macros[name]))

    # --- tokens ---
    def match(self, c):
        got = self.get()
        if got != c:
            raise SceneNodeError(f"{self.path}: expected '{c}', got '{got}'")

    def skip_blanks(self):
        while not self._eof():
            c = self.peek(escape_macro=True)
            if c in " \t\n":
                self._raw_get()
            elif c == "/":
                self._raw_get()
                self.match("/")
                while not self._eof() and self._raw_get() != "\n":
                    pass
            else:
                break

    def read_identifier(self, escape_macro=False):
        c = self.get(escape_macro)
        if not (c.isalpha() or c in "$_"):
            raise SceneNodeError(f"{self.path}: invalid identifier start '{c}'")
        out = [c]
        while not self._eof():
            c = self.peek(escape_macro)
            if c.isalnum() or c in "_$-":
                out.append(self.get(escape_macro))
            else:
                break
        return "".join(out)

    def read_number(self):
        s = []
        if self.peek() == "+":
            self.get()
            self.skip_blanks()
        elif self.peek() == "-":
            s.append(self.get())
            self.skip_blanks()
        while not self._eof() and (self.peek().isdigit() or self.peek() in ".e-+"):
            s.append(self.get())
        try:
            return float("".join(s))
        except ValueError:
            raise SceneNodeError(f"{self.path}: invalid number '{''.join(s)}'")

    def read_bool(self):
        word = "true" if self.peek() == "t" else "false"
        for ch in word:
            self.match(ch)
        return word == "true"

    def read_string(self):
        quote = self.get()
        if quote not in "\"'":
            raise SceneNodeError(f"{self.path}: expected string, got '{quote}'")
        out = []
        c = self.get()
        escapes = {"b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t",
                   "\\": "\\", "'": "'", '"': '"', "#": "#"}
        while c != quote:
            if c == "\\":
                esc = self.get(escape_macro=True)
                if esc not in escapes:
                    raise SceneNodeError(f"{self.path}: bad escape '\\{esc}'")
                c = escapes[esc]
            out.append(c)
            c = self.get()
        return "".join(out)

    # --- grammar ---
    def parse(self):
        self.skip_blanks()
        while not self._eof():
            token = self.read_identifier()
            if token == "import":
                self.skip_blanks()
                p = Path(self.read_string())
                if not p.is_absolute():
                    p = self.path.parent / p
                parse_text_file(self.desc, p, self.macros)
            elif token == "define":
                self.skip_blanks()
                key = self.read_identifier(escape_macro=True)
                self.skip_blanks()
                value = []
                while not self._eof() and self._raw_peek() not in "\n/":
                    value.append(self._raw_get())
                # CLI macros override in-file defines (scene_parser.cpp:445)
                self.macros.setdefault(key, "".join(value).strip())
            elif token == ROOT_NODE_IDENTIFIER:
                node = self.desc.define_root(str(self.path))
                self.parse_node_body(node)
            else:
                self.parse_global_node(token)
            self.skip_blanks()

    def parse_global_node(self, tag_desc):
        tag = parse_scene_node_tag(tag_desc)
        if tag is None or tag in (SceneNodeTag.ROOT, SceneNodeTag.INTERNAL):
            raise SceneNodeError(f"{self.path}: invalid node type '{tag_desc}'")
        self.skip_blanks()
        name = self.read_identifier()
        self.skip_blanks()
        impl_type, base = "", None
        if self.peek() == ":":
            self.match(":")
            self.skip_blanks()
            impl_type = self.read_identifier()
            self.skip_blanks()
            if self.peek() == "(":
                base = self.parse_base()
            self.skip_blanks()
        node = self.desc.define(name, tag, impl_type, str(self.path), base)
        self.parse_node_body(node)

    def parse_base(self):
        self.match("(")
        self.skip_blanks()
        self.match("@")
        name = self.read_identifier()
        self.skip_blanks()
        self.match(")")
        return self.desc.reference(name)

    def parse_node_body(self, node):
        self.skip_blanks()
        self.match("{")
        self.skip_blanks()
        while self.peek() != "}":
            prop = self.read_identifier()
            self.skip_blanks()
            if self.peek() == ":":
                self.get()
                self.skip_blanks()
                impl_type = self.read_identifier()
                base = None
                if self.peek() == "(":
                    base = self.parse_base()
                internal = self.desc.define_internal(impl_type, str(self.path), base)
                self.parse_node_body(internal)
                node.properties[prop] = internal
            else:
                node.properties[prop] = self.parse_value_list(node)
            self.skip_blanks()
        self.match("}")

    def parse_value_list(self, node):
        self.match("{")
        self.skip_blanks()
        c = self.peek()
        if c == "}":
            raise SceneNodeError(f"{self.path}: empty value list")
        if c == "@" or c.isupper():
            values = self.parse_node_items(node)
        elif c in "\"'":
            values = self.parse_items(self.read_string)
        elif c in "tf":
            values = self.parse_items(self.read_bool)
        else:
            values = self.parse_items(self.read_number)
        self.skip_blanks()
        self.match("}")
        return values

    def parse_items(self, read_fn):
        out = [read_fn()]
        self.skip_blanks()
        while self.peek() != "}":
            self.match(",")
            self.skip_blanks()
            out.append(read_fn())
            self.skip_blanks()
        return out

    def parse_node_items(self, node):
        def one():
            if self.peek() == "@":
                self.get()
                self.skip_blanks()
                return self.desc.reference(self.read_identifier())
            impl_type = self.read_identifier()
            base = None
            if self.peek() == "(":
                base = self.parse_base()
            internal = self.desc.define_internal(impl_type, str(self.path), base)
            self.parse_node_body(internal)
            return internal

        out = [one()]
        self.skip_blanks()
        while self.peek() != "}":
            self.match(",")
            self.skip_blanks()
            out.append(one())
            self.skip_blanks()
        return out


def parse_text_file(desc: SceneDesc, path, macros: dict):
    _TextParser(desc, path, macros).parse()
