"""Energy-expression compiler for the Custom*Force classes.

A Lepton-compatible parser (the grammar of OpenMM's Custom*Force energy
strings) that compiles an expression once, at compile time, to a
function of torch tensors: forces come from torch.autograd.grad of the
energy (forces/custom.py).  The same grammar, function set, error
messages (ExpressionError), expression_names and expression_functions as
the JAX package's utils/expr.py.

Grammar:

  expression := segment (';' name '=' segment)*
  segment    := sum
  sum        := product (('+'|'-') product)*
  product    := unary (('*'|'/') unary)*
  unary      := ('+'|'-') unary | power
  power      := atom ('^' unary)?          (right-associative)
  atom       := number | name | name '(' args ')' | '(' segment ')'

Intermediate definitions after ';' are evaluated right to left (later
definitions are visible to earlier ones), as in OpenMM.

Functions: sqrt exp log sin cos sec csc tan cot asin acos atan atan2
sinh cosh tanh erf erfc step delta select min max abs floor ceil
square cube recip.  `x^k` with a constant integer k is an integer power
(torch.pow with an int exponent), defined for x < 0, where exp(k log x)
would be NaN.  Numbers stay Python floats until they meet a tensor; a
function of a constant alone takes it as a 0-d float64 tensor.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence, Tuple

import torch

__all__ = ["parse", "compile_expression", "expression_names",
           "expression_functions", "ExpressionError"]


class ExpressionError(ValueError):
    pass


_TOKEN = re.compile(r"""
    (?P<num>(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>[-+*/^(),])
""", re.VERBOSE)


def _tokenize(s: str) -> List[Tuple[str, str]]:
    out, i = [], 0
    while i < len(s):
        if s[i].isspace():
            i += 1
            continue
        m = _TOKEN.match(s, i)
        if not m:
            raise ExpressionError(f"unexpected character {s[i]!r} in "
                                  f"expression {s!r}")
        out.append((m.lastgroup, m.group()))
        i = m.end()
    out.append(("end", ""))
    return out


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokenize(text)
        self.pos = 0
        self.text = text

    def peek(self):
        return self.toks[self.pos]

    def next(self):
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, val):
        k, v = self.next()
        if v != val:
            raise ExpressionError(f"expected {val!r}, found {v!r} in "
                                  f"{self.text!r}")

    def parse(self):
        node = self.sum()
        k, v = self.peek()
        if k != "end":
            raise ExpressionError(f"trailing tokens from {v!r} in "
                                  f"{self.text!r}")
        return node

    def sum(self):
        node = self.product()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = ("bin", op, node, self.product())
        return node

    def product(self):
        node = self.unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            node = ("bin", op, node, self.unary())
        return node

    def unary(self):
        if self.peek()[1] == "-":
            self.next()
            return ("neg", self.unary())
        if self.peek()[1] == "+":
            self.next()
            return self.unary()
        return self.power()

    def power(self):
        node = self.atom()
        if self.peek()[1] == "^":
            self.next()
            # right-associative; exponent binds unary minus: x^-2
            node = ("bin", "^", node, self.unary())
        return node

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", float(val))
        if kind == "name":
            if self.peek()[1] == "(":
                self.next()
                args = [self.sum()]
                while self.peek()[1] == ",":
                    self.next()
                    args.append(self.sum())
                self.expect(")")
                return ("call", val, args)
            return ("var", val)
        if val == "(":
            node = self.sum()
            self.expect(")")
            return node
        raise ExpressionError(f"unexpected token {val!r} in {self.text!r}")


def parse(text: str):
    """Parse a single expression segment (no ';' definitions) to an AST."""
    return _Parser(text).parse()


def _t(x):
    """A tensor of x (a Python number becomes a 0-d float64 tensor)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(float(x), dtype=torch.float64)


def _tensor_fn(f):
    return lambda *xs: f(*(_t(x) for x in xs))


_F = {name: _tensor_fn(f) for name, f in {
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "erf": torch.erf, "erfc": torch.erfc,
    "floor": torch.floor, "ceil": torch.ceil, "abs": torch.abs,
    "square": lambda x: x * x, "cube": lambda x: x * x * x,
    "recip": lambda x: 1.0 / x,
    "sec": lambda x: 1.0 / torch.cos(x), "csc": lambda x: 1.0 / torch.sin(x),
    "cot": lambda x: 1.0 / torch.tan(x),
}.items()}
_F2 = {name: _tensor_fn(f) for name, f in {
    "atan2": torch.atan2, "min": torch.minimum,
    "max": torch.maximum}.items()}


def _int_pow(base, k: int):
    if isinstance(base, torch.Tensor):
        return torch.pow(base, k)
    return float(base) ** k


def _eval(node, env, text):
    kind = node[0]
    if kind == "num":
        return node[1]
    if kind == "var":
        name = node[1]
        if name not in env:
            raise ExpressionError(
                f"unknown variable {name!r} in {text!r} (available: "
                f"{sorted(env)})")
        return env[name]
    if kind == "neg":
        return -_eval(node[1], env, text)
    if kind == "bin":
        op, a, b = node[1], node[2], node[3]
        if op == "^":
            base = _eval(a, env, text)
            # constant integer exponents are integer powers, defined
            # for a negative base
            if b[0] == "num" and float(b[1]).is_integer():
                return _int_pow(base, int(b[1]))
            if b[0] == "neg" and b[1][0] == "num" \
                    and float(b[1][1]).is_integer():
                return _int_pow(base, -int(b[1][1]))
            ex = _eval(b, env, text)
            if isinstance(base, torch.Tensor) or isinstance(
                    ex, torch.Tensor):
                return torch.pow(_t(base), ex)
            return float(base) ** float(ex)
        av, bv = _eval(a, env, text), _eval(b, env, text)
        if op == "+":
            return av + bv
        if op == "-":
            return av - bv
        if op == "*":
            return av * bv
        return av / bv
    # call
    fname, args = node[1], node[2]
    vals = [_eval(a, env, text) for a in args]
    if fname in _F:
        if len(vals) != 1:
            raise ExpressionError(f"{fname}() takes 1 argument in {text!r}")
        return _F[fname](vals[0])
    if fname in _F2:
        if len(vals) != 2:
            raise ExpressionError(f"{fname}() takes 2 arguments in {text!r}")
        return _F2[fname](vals[0], vals[1])
    if fname == "step":
        if len(vals) != 1:
            raise ExpressionError(f"step() takes 1 argument in {text!r}")
        x = _t(vals[0])
        return (~(x < 0)).to(x.dtype)
    if fname == "delta":
        if len(vals) != 1:
            raise ExpressionError(f"delta() takes 1 argument in {text!r}")
        x = _t(vals[0])
        return (x == 0).to(x.dtype)
    if fname == "select":
        if len(vals) != 3:
            raise ExpressionError(f"select() takes 3 arguments in {text!r}")
        return torch.where(_t(vals[0]) == 0, _t(vals[2]), _t(vals[1]))
    # caller-registered functions (CustomExternalForce's
    # periodicdistance, a closure over the current box): callables in the
    # evaluation env, their arity checked by _check_calls from the
    # extra_fns table given to compile_expression
    if fname in env and callable(env[fname]):
        return env[fname](*vals)
    raise ExpressionError(f"unknown function {fname!r} in {text!r}")


def _segments(text: str):
    """Split 'expr; name=expr; ...' into (main, [(name, ast), ...])."""
    parts = [p for p in text.split(";") if p.strip()]
    if not parts:
        raise ExpressionError("empty energy expression")
    main = parse(parts[0])
    defs = []
    for p in parts[1:]:
        if "=" not in p:
            raise ExpressionError(
                f"definition {p.strip()!r} lacks '=' in {text!r}")
        name, body = p.split("=", 1)
        name = name.strip()
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
            raise ExpressionError(f"bad intermediate name {name!r}")
        defs.append((name, parse(body)))
    return main, defs


def _free_names(node, out):
    if node[0] == "var":
        out.add(node[1])
    elif node[0] == "neg":
        _free_names(node[1], out)
    elif node[0] == "bin":
        _free_names(node[2], out)
        _free_names(node[3], out)
    elif node[0] == "call":
        for a in node[2]:
            _free_names(a, out)


_ARITY = dict({f: 1 for f in _F}, **{f: 2 for f in _F2},
              step=1, delta=1, select=3)


def _check_calls(node, text, extra_arity=None):
    arity = dict(_ARITY, **(extra_arity or {}))
    if node[0] == "neg":
        _check_calls(node[1], text, extra_arity)
    elif node[0] == "bin":
        _check_calls(node[2], text, extra_arity)
        _check_calls(node[3], text, extra_arity)
    elif node[0] == "call":
        fname, args = node[1], node[2]
        if fname not in arity:
            raise ExpressionError(f"unknown function {fname!r} in {text!r}")
        if len(args) != arity[fname]:
            raise ExpressionError(
                f"{fname}() takes {arity[fname]} argument(s), got "
                f"{len(args)} in {text!r}")
        for a in args:
            _check_calls(a, text, extra_arity)


def expression_names(text: str) -> set:
    """Free variable names of a full expression (main + definitions,
    with defined intermediates removed)."""
    main, defs = _segments(text)
    free: set = set()
    _free_names(main, free)
    for _, ast in defs:
        _free_names(ast, free)
    return free - {name for name, _ in defs}


def _call_names(node, out):
    if node[0] == "neg":
        _call_names(node[1], out)
    elif node[0] == "bin":
        _call_names(node[2], out)
        _call_names(node[3], out)
    elif node[0] == "call":
        out.add(node[1])
        for a in node[2]:
            _call_names(a, out)


def expression_functions(text: str) -> set:
    """Function names called anywhere in a full expression (used e.g. to
    detect `periodicdistance` for usesPeriodicBoundaryConditions)."""
    main, defs = _segments(text)
    fns: set = set()
    _call_names(main, fns)
    for _, ast in defs:
        _call_names(ast, fns)
    return fns


def compile_expression(text: str, variables: Sequence[str],
                       extra_fns: Dict[str, int] | None = None
                       ) -> Callable[..., object]:
    """Compile an OpenMM-style energy expression to
    ``fn(env: Dict[str, value]) -> value`` on torch tensors.

    `variables` is the full set of names the caller will supply (base
    variables like 'r'/'theta', per-term parameters, global parameters).
    Unknown names raise ExpressionError at compile time, not when the
    function runs.
    Intermediate ';' definitions are evaluated right-to-left (OpenMM
    semantics: later definitions are visible to earlier ones).

    `extra_fns` registers caller-supplied functions (name -> arity); the
    caller must bind each name to a callable in the evaluation env (e.g.
    CustomExternalForce binds ``periodicdistance`` to a closure over the
    current box).
    """
    main, defs = _segments(text)
    _check_calls(main, text, extra_fns)
    for _, ast in defs:
        _check_calls(ast, text, extra_fns)
    known = set(variables)
    # right-to-left: each definition may use everything to its right
    avail = set(known)
    for name, ast in reversed(defs):
        free = set()
        _free_names(ast, free)
        missing = free - avail
        if missing:
            raise ExpressionError(
                f"unknown name(s) {sorted(missing)} in definition of "
                f"{name!r} (expression {text!r})")
        avail.add(name)
    free = set()
    _free_names(main, free)
    missing = free - avail
    if missing:
        raise ExpressionError(
            f"unknown name(s) {sorted(missing)} in {text!r} "
            f"(available: {sorted(avail)})")

    def fn(env: Dict[str, object]):
        e = dict(env)
        for name, ast in reversed(defs):
            e[name] = _eval(ast, e, text)
        return _eval(main, e, text)

    return fn
