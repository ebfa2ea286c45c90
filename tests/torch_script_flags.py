"""Readers of a benchmark script's settings, by `ast` (no script is run):
its argparse flags and defaults, its literal assignments (module level or
in functions, `os.environ.get` defaults included), a function's keyword
defaults and a call's literal keywords.  The port's script tests
(tests/test_torch_bench_scripts.py, tests/test_torch_measure_flags.py)
hold the port's scripts to the JAX repository's with them."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "flash_attn_v100_tpu_torch" / "benchmarks"
JAX = ROOT / "benchmarks"


def _tree(path: Path):
    return ast.parse(path.read_text())


def _literal(node):
    """A literal's value; `int(os.environ.get(NAME, "v"))` and
    `os.environ.get(NAME, "v")` give their default, converted; a name
    `jnp.x` gives "x"; `1 << 30` its value."""
    if isinstance(node, ast.Call):
        f = node.func
        if (isinstance(f, ast.Name) and f.id in ("int", "float")
                and node.args):
            return {"int": int, "float": float}[f.id](_literal(node.args[0]))
        if isinstance(f, ast.Attribute) and f.attr == "get" and node.args:
            return ast.literal_eval(node.args[1])
        raise ValueError("not a literal")
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift):
        return _literal(node.left) << _literal(node.right)
    return ast.literal_eval(node)


def flags(path: Path) -> dict:
    """{flag: (type name, default)} of a script's ap.add_argument calls."""
    out = {}
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            typ = kw.get("type")
            out[node.args[0].value] = (
                typ.id if isinstance(typ, ast.Name) else None,
                _literal(kw["default"]) if "default" in kw else None)
    return out


def assignments(path: Path) -> dict:
    """{name: value} of every assignment of literals in the script, at any
    depth (the first one of a name), tuple targets unpacked."""
    out = {}
    for node in ast.walk(_tree(path)):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt, val = node.targets[0], node.value
        pairs = ([(tgt, val)] if isinstance(tgt, ast.Name) else
                 list(zip(tgt.elts, val.elts))
                 if isinstance(tgt, ast.Tuple) and isinstance(val, ast.Tuple)
                 else [])
        for t, v in pairs:
            try:
                out.setdefault(t.id, _literal(v))
            except (ValueError, TypeError, KeyError, IndexError):
                pass
    return out


def env_defaults(path: Path) -> dict:
    """{NAME: default} of every `os.environ.get(NAME, default)` call."""
    out = {}
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get" and len(node.args) == 2
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "environ"):
            out[ast.literal_eval(node.args[0])] = ast.literal_eval(
                node.args[1])
    return out


def function_defaults(path: Path, name: str) -> dict:
    """{argument: default} of the function `name`'s keyword defaults."""
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            args = node.args.args[len(node.args.args)
                                  - len(node.args.defaults):]
            return {a.arg: ast.literal_eval(d)
                    for a, d in zip(args, node.args.defaults)}
    raise KeyError(name)


def calls(path: Path, func: str) -> list:
    """[(positional literals, {keyword: literal})] of every call of the
    name `func` in the script."""
    out = []
    for node in ast.walk(_tree(path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == func):
            out.append(([_literal(a) for a in node.args],
                        {k.arg: _literal(k.value) for k in node.keywords}))
    return out


def function_source(path: Path, name: str) -> str:
    """The source of the (possibly nested) function `name`, dedented."""
    import textwrap
    src = path.read_text()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return textwrap.dedent(ast.get_source_segment(src, node))
    raise KeyError(name)
