"""Carried from olavm_tpu/interpreter/prophet.py: the port imports nothing of olavm_tpu, so it
keeps its own copy; the code is unchanged.

Prophet DSL interpreter (non-deterministic hint language).

A compact recursive-descent implementation of the reference's prophet
mini-language (interpreter/src/: lexer, parser, sema,
executor). Semantics match the reference executor:

- `felt` values are plain (non-modular) integers — `/` and `%` are integer
  division/remainder (interpreter/src/utils/number.rs:141-176; e.g.
  `split_hi(x) = x / 2^32` splits a field element's high 32 bits);
- `cid.<name>` identifiers address prophet inputs/outputs;
- builtins: `sqrt` (exact integer sqrt), `malloc(len)` (advances the heap
  pointer ctx value and returns the new hp,
  interpreter/src/interpreter/executor.rs:656-671), `printf(addr, flag)`;
- the entry() result is [outputs..., ctx values...] with the heap pointer
  last (executor.rs:294-330), which the Process pops as the new hp.

Grammar subset: function definitions with typed params and `return`,
`entry() { ... }`, declarations (`felt x = e;` / `u32 x = e;`), assignment,
`if`/`else`, `while`, arithmetic (+ - * / %), comparisons, calls.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional

HEAP_PTR = "hp"

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+)"
    r"|(?P<id>[A-Za-z_][A-Za-z_0-9]*(?:\.[A-Za-z_][A-Za-z_0-9]*)*)"
    r"|(?P<op>->|==|!=|<=|>=|&&|\|\||[-+*/%(){},;=<>!\[\]]))"
)

KEYWORDS = {"function", "entry", "return", "if", "else", "while",
            "felt", "u32", "uint", "cid"}
BUILTINS = {"sqrt", "malloc", "printf"}


class ProphetError(Exception):
    pass


def tokenize(src: str) -> list[str]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            if src[pos:].strip() == "":
                break
            raise ProphetError(f"prophet lex error at {src[pos:pos+20]!r}")
        out.append(m.group(0).strip())
        pos = m.end()
    return out


@dataclass
class Func:
    name: str
    params: list[str]
    body: list  # stmt nodes


class Parser:
    """Tokens -> (functions, entry_body). Nodes are tuples."""

    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ProphetError("unexpected end of prophet code")
        self.i += 1
        return t

    def expect(self, t: str):
        got = self.next()
        if got != t:
            raise ProphetError(f"expected {t!r}, got {got!r}")

    def parse_program(self):
        funcs: dict[str, Func] = {}
        entry = None
        while self.peek() is not None:
            if self.peek() == "function":
                f = self.parse_function()
                funcs[f.name] = f
            elif self.peek() == "entry":
                self.next()
                self.expect("(")
                self.expect(")")
                entry = self.parse_block()
            else:
                raise ProphetError(f"unexpected token {self.peek()!r}")
        if entry is None:
            raise ProphetError("prophet has no entry block")
        return funcs, entry

    def parse_function(self) -> Func:
        self.expect("function")
        name = self.next()
        self.expect("(")
        params = []
        while self.peek() != ")":
            tok = self.next()
            if tok in ("felt", "u32", "uint"):
                tok = self.next()
            params.append(tok)
            if self.peek() == ",":
                self.next()
        self.expect(")")
        if self.peek() == "->":
            self.next()
            self.next()  # return type
        body = self.parse_block()
        return Func(name, params, body)

    def parse_block(self) -> list:
        self.expect("{")
        stmts = []
        while self.peek() != "}":
            stmts.append(self.parse_stmt())
        self.expect("}")
        return stmts

    def parse_stmt(self):
        t = self.peek()
        if t == "return":
            self.next()
            e = self.parse_expr()
            self.expect(";")
            return ("return", e)
        if t == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_block()
            els = []
            if self.peek() == "else":
                self.next()
                els = self.parse_block()
            return ("if", cond, then, els)
        if t == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            body = self.parse_block()
            return ("while", cond, body)
        if t in ("felt", "u32", "uint"):
            self.next()
            name = self.next()
            init = None
            if self.peek() == "=":
                self.next()
                init = self.parse_expr()
            self.expect(";")
            return ("decl", name, init)
        # assignment or bare expression
        e = self.parse_expr()
        if self.peek() == "=":
            if e[0] != "var":
                raise ProphetError(f"invalid assignment target {e}")
            self.next()
            rhs = self.parse_expr()
            self.expect(";")
            return ("assign", e[1], rhs)
        self.expect(";")
        return ("expr", e)

    # precedence climbing
    def parse_expr(self):
        return self.parse_cmp()

    def parse_cmp(self):
        lhs = self.parse_addsub()
        while self.peek() in ("==", "!=", "<", ">", "<=", ">="):
            op = self.next()
            rhs = self.parse_addsub()
            lhs = ("bin", op, lhs, rhs)
        return lhs

    def parse_addsub(self):
        lhs = self.parse_muldiv()
        while self.peek() in ("+", "-"):
            op = self.next()
            rhs = self.parse_muldiv()
            lhs = ("bin", op, lhs, rhs)
        return lhs

    def parse_muldiv(self):
        lhs = self.parse_unary()
        while self.peek() in ("*", "/", "%"):
            op = self.next()
            rhs = self.parse_unary()
            lhs = ("bin", op, lhs, rhs)
        return lhs

    def parse_unary(self):
        if self.peek() == "-":
            self.next()
            return ("bin", "-", ("num", 0), self.parse_unary())
        return self.parse_primary()

    def parse_primary(self):
        t = self.next()
        if t == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t.isdigit():
            return ("num", int(t))
        # identifier / call
        if self.peek() == "(":
            self.next()
            args = []
            while self.peek() != ")":
                args.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            return ("call", t, args)
        return ("var", t)


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class ProphetInterpreter:
    """Executes one prophet invocation."""

    def __init__(self, code: str, mem_reader=None):
        m = re.match(r"^%\{([\s\S]*)%\}$", code.strip())
        if not m:
            raise ProphetError("prophet code missing %{ %} wrapper")
        self.funcs, self.entry = Parser(tokenize(m.group(1))).parse_program()
        self.mem_reader = mem_reader  # addr -> value (for printf)

    def run(self, prophet: dict, values: list[int], ctx: list[tuple]) -> list[int]:
        """Returns [outputs..., ctx values(hp last)...] like the reference."""
        scope: dict[str, int] = {}
        idx = 0
        outputs: list[str] = []
        ctx_names: list[str] = []
        for inp in prophet.get("inputs", []):
            name, length = inp["name"], inp.get("length", 1)
            if length == 1:
                scope[name] = values[idx]
            else:
                scope[name] = list(values[idx : idx + length])
            idx += length
        for name, value in ctx:
            scope[name] = value
            ctx_names.append(name)
        for outp in prophet.get("outputs", []):
            outputs.append(outp["name"])
            scope.setdefault(outp["name"], None)

        self.globals = scope
        for stmt in self.entry:
            self.exec_stmt(stmt, scope)

        out_values: list[int] = []
        for name in outputs:
            v = scope.get(name)
            if v is None:
                continue
            if isinstance(v, list):
                out_values.extend(v)
            else:
                out_values.append(v)
        for name in ctx_names:
            v = scope.get(name)
            if v is not None:
                out_values.append(v)
        return out_values

    # ----- execution -----

    def exec_block(self, stmts, scope):
        for s in stmts:
            self.exec_stmt(s, scope)

    def exec_stmt(self, stmt, scope):
        kind = stmt[0]
        if kind == "return":
            raise _Return(self.eval(stmt[1], scope))
        if kind == "assign":
            name = stmt[1]
            val = self.eval(stmt[2], scope)
            target = scope if (name in scope or name in self.globals) else scope
            if name in self.globals and name not in scope:
                self.globals[name] = val
            else:
                target[name] = val
            return
        if kind == "decl":
            scope[stmt[1]] = self.eval(stmt[2], scope) if stmt[2] else 0
            return
        if kind == "if":
            if self.eval(stmt[1], scope):
                self.exec_block(stmt[2], scope)
            else:
                self.exec_block(stmt[3], scope)
            return
        if kind == "while":
            while self.eval(stmt[1], scope):
                self.exec_block(stmt[2], scope)
            return
        if kind == "expr":
            self.eval(stmt[1], scope)
            return
        raise ProphetError(f"unknown statement {kind}")

    def eval(self, node, scope):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "var":
            name = node[1]
            if name in scope:
                return scope[name]
            if name in self.globals:
                return self.globals[name]
            raise ProphetError(f"undefined identifier {name}")
        if kind == "bin":
            op = node[1]
            a = self.eval(node[2], scope)
            b = self.eval(node[3], scope)
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a // b
            if op == "%":
                return a % b
            if op == "==":
                return int(a == b)
            if op == "!=":
                return int(a != b)
            if op == "<":
                return int(a < b)
            if op == ">":
                return int(a > b)
            if op == "<=":
                return int(a <= b)
            if op == ">=":
                return int(a >= b)
            raise ProphetError(f"unknown op {op}")
        if kind == "call":
            name, args = node[1], [self.eval(a, scope) for a in node[2]]
            if name == "sqrt":
                r = math.isqrt(args[0])
                return r
            if name == "malloc":
                # returns hp + len and advances the heap pointer
                # (interpreter/src/interpreter/executor.rs:656-671)
                new_hp = self.globals[HEAP_PTR] + args[0]
                self.globals[HEAP_PTR] = new_hp
                return new_hp
            if name == "printf":
                self._printf(args)
                return 0
            fn = self.funcs.get(name)
            if fn is None:
                raise ProphetError(f"unknown function {name}")
            local = dict(zip(fn.params, args))
            try:
                self.exec_block(fn.body, local)
            except _Return as r:
                return r.value
            return 0
        raise ProphetError(f"unknown expr {kind}")

    def _printf(self, args):
        # printf(base_addr, flag) — reference executor.rs:673-760
        if self.mem_reader is None:
            return
        addr, flag = args[0], args[1]
        if flag == 3:
            print(f"print value={addr}")
        elif flag == 2:
            vals = [self.mem_reader(addr + i) for i in range(4)]
            print("print addr:=" + ",".join(str(v) for v in vals))
        elif flag == 1:
            ln = self.mem_reader(addr)
            chars = bytes(self.mem_reader(addr + 1 + i) & 0xFF for i in range(ln))
            print(f"print str={chars.decode('utf-8', 'replace')}")
        elif flag == 0:
            ln = self.mem_reader(addr)
            for i in range(ln):
                print(f"print mem:{addr + 1 + i},value:{self.mem_reader(addr + 1 + i)}")
