"""Port copy of ``trino_tpu/sql/tokenizer.py`` (no edits beyond import targets
noted inline).

SQL tokenizer.

Reference: the lexer rules of core/trino-grammar's SqlBase.g4 (identifiers,
quoted identifiers, string/number literals, comments, operators). Keywords
are recognized case-insensitively; non-reserved words double as identifiers
at the parser's discretion.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List

TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
  | (?P<number>\d+\.\d*|\.\d+|\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<qident>"(?:[^"]|"")*")
  | (?P<name>[A-Za-z_][A-Za-z0-9_$]*)
  | (?P<op><>|!=|>=|<=|\|\||->|[(),.;*/%+\-<>=\[\]?])
""", re.VERBOSE | re.DOTALL)


@dataclass
class Token:
    kind: str      # 'number' | 'string' | 'name' | 'op' | 'eof'
    text: str      # names upper-cased for keyword matching
    raw: str
    pos: int


class SqlSyntaxError(Exception):
    def __init__(self, message: str, sql: str = "", pos: int = 0):
        line = sql.count("\n", 0, pos) + 1
        col = pos - (sql.rfind("\n", 0, pos) + 1) + 1
        super().__init__(f"{message} at line {line}:{col}")
        self.pos = pos


def tokenize(sql: str) -> List[Token]:
    tokens: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlSyntaxError(f"unexpected character {sql[pos]!r}",
                                 sql, pos)
        kind = m.lastgroup
        text = m.group()
        if kind != "ws":
            if kind == "name":
                tokens.append(Token("name", text.upper(), text, pos))
            elif kind == "string":
                tokens.append(Token("string", text[1:-1].replace("''", "'"),
                                    text, pos))
            elif kind == "qident":
                tokens.append(Token("qident",
                                    text[1:-1].replace('""', '"'),
                                    text, pos))
            else:
                tokens.append(Token(kind, text, text, pos))
        pos = m.end()
    tokens.append(Token("eof", "", "", len(sql)))
    return tokens
