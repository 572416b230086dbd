"""Declarative YAML block descriptors (reference:
newsched_tpu/runtime/blockspec.py; GNU Radio's blockbuilder codegen,
utils/blockbuilder and the per-block .yml, SURVEY.md §3.5).

GNU Radio parses a YAML descriptor and generates the public class, factory,
bindings and GRC metadata from it, leaving only work() to write by hand.
Here the descriptor IS the runtime spec: ``block_from_yaml`` builds a Block
subclass (ports, parameters, rate) and takes the work either as a Python
callable or, for elementwise blocks, as a torch expression in the
descriptor (``expr:``), evaluated over the block's input tensors, its
static parameters and its parameter tensors with ``torch`` and ``np`` in
scope. An expression written for the JAX package (it names ``jnp`` or
``jax``) is refused when the class is built, with its torch spelling.

``yaml`` (PyYAML) is imported only inside the functions that parse or emit
YAML, so importing this module, or any graph on a machine without PyYAML,
never needs it.

Descriptor shape (the reference's file_format 1):

    module: math
    block: scale_offset
    label: Scale & Offset
    blocktype: sync_block
    parameters:
      - id: k
        dtype: rf32
        default: 2.0
        settable: true
    ports:
      - {domain: stream, id: in,  direction: input,  type: cf32}
      - {domain: stream, id: out, direction: output, type: cf32}
    relative_rate: "1"          # optional Fraction string or static expr
    in_multiple: "n"            # optional input grouping constraint
    expr: "in_ * k"             # optional elementwise kernel
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable

import numpy as np
import torch

from newsched_tpu_torch.runtime.block import Block
from newsched_tpu_torch.utils.dtypes import port_dtype

def _yaml():
    """PyYAML, imported at first use; a clear error where it is absent."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "PyYAML is not installed: YAML block descriptors "
            "(runtime/blockspec.py, blocks/yml_blocks.py) need it; the rest "
            "of newsched_tpu_torch runs without it") from e
    return yaml


_DTYPES = {
    "rf32": np.float32,
    "cf32": np.complex64,
    "ri32": np.int32,
    "ri16": np.int16,
    "size": np.int32,
    "float": np.float32,
    "double": np.float32,
}


def _eval_static(expr: str, statics: dict, frac: bool = False):
    """Evaluate a descriptor sizing expression over static parameters with a
    restricted AST walk — names, integer literals, + - * / // % ** and
    comparisons/boolean ops only (no calls, no attributes, no subscripts).
    Descriptor `expr:` work kernels remain trusted code like the reference's
    generated C++, but the SIZING fields (relative_rate, in_multiple,
    validate) are plain arithmetic and get no eval() surface."""
    import ast

    env = {k: (Fraction(v) if frac else int(v)) for k, v in statics.items()}

    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, bool)):
            return Fraction(node.value) if frac and not isinstance(node.value, bool) \
                else node.value
        if isinstance(node, ast.Name):
            if node.id not in env:
                raise ValueError(f"unknown static parameter {node.id!r} in "
                                 f"descriptor expression {expr!r}")
            return env[node.id]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.Not)):
            v = walk(node.operand)
            return -v if isinstance(node.op, ast.USub) else not v
        if isinstance(node, ast.BinOp):
            a, b = walk(node.left), walk(node.right)
            def _pow():
                # an unbounded '2**2**64' would hang or exhaust memory at
                # block construction; sizing expressions need no big powers
                if not (-64 <= b <= 64) or abs(a) > (1 << 32):
                    raise ValueError(
                        f"power out of range in descriptor expression "
                        f"{expr!r} (|exponent| <= 64, |base| <= 2^32)")
                return a ** b

            ops = {ast.Add: lambda: a + b, ast.Sub: lambda: a - b,
                   ast.Mult: lambda: a * b, ast.FloorDiv: lambda: a // b,
                   ast.Mod: lambda: a % b, ast.Pow: _pow,
                   ast.Div: lambda: Fraction(a) / b if frac else a / b}
            fn = ops.get(type(node.op))
            if fn is None:
                raise ValueError(f"operator {type(node.op).__name__} not allowed "
                                 f"in descriptor expression {expr!r}")
            return fn()
        if isinstance(node, ast.Compare):
            left = walk(node.left)
            for op, comp in zip(node.ops, node.comparators):
                right = walk(comp)
                ok = {ast.Lt: left < right, ast.LtE: left <= right,
                      ast.Gt: left > right, ast.GtE: left >= right,
                      ast.Eq: left == right, ast.NotEq: left != right}.get(type(op))
                if ok is None:
                    raise ValueError(f"comparison {type(op).__name__} not allowed")
                if not ok:
                    return False
                left = right
            return True
        if isinstance(node, ast.BoolOp):
            vals = [walk(v) for v in node.values]
            return all(vals) if isinstance(node.op, ast.And) else any(vals)
        raise ValueError(f"syntax {type(node).__name__} not allowed in "
                         f"descriptor expression {expr!r}")

    return walk(ast.parse(expr, mode="eval"))


_JAX_NAMES = ("jnp", "jax")


def _check_torch_expr(expr: str, block: str) -> None:
    """Refuse an ``expr:`` written for the JAX package, naming its torch
    spelling."""
    import ast

    named = sorted({n.id for n in ast.walk(ast.parse(expr, mode="eval"))
                    if isinstance(n, ast.Name) and n.id in _JAX_NAMES})
    if named:
        hint = expr.replace("jnp.", "torch.").replace("jax.lax.", "torch.")
        raise ValueError(
            f"block {block}: expr {expr!r} names {', '.join(named)}; "
            f"descriptors here are evaluated with torch: write it as "
            f"{hint!r} (and .astype(t) as .to(t))")


def _make_expr_work(expr: str, out_port: str):
    code = compile(expr, "<block expr>", "eval")

    def work(self, state, ins, params, nout):
        ns = {"torch": torch, "np": np}
        for k, v in ins.items():
            ns[k] = v
            ns[k + "_"] = v  # `in` is a keyword; expose `in_`
        ns.update(getattr(self, "_statics", {}))
        ns.update(params)
        return state, {out_port: eval(code, ns)}

    return work


def block_from_yaml(descriptor: str, work: Callable | None = None) -> type[Block]:
    """Build a Block subclass from a YAML descriptor string or file path.

    `work(self, state, ins, params, nout)` overrides any `expr` in the
    descriptor; one of the two must be provided. Needs PyYAML.
    """
    yaml = _yaml()
    if "\n" not in descriptor and descriptor.endswith((".yml", ".yaml")):
        with open(descriptor) as fh:
            spec = yaml.safe_load(fh)
    else:
        spec = yaml.safe_load(descriptor)

    name = spec["block"]
    ports = spec.get("ports", [])
    params = spec.get("parameters", [])
    rate_str = str(spec.get("relative_rate", "1"))
    # An alphabetic rate is an expression over static parameters, resolved
    # per instance in __init__; the class default stays 1.
    rate = Fraction(1) if any(c.isalpha() for c in rate_str) else Fraction(rate_str)
    expr = spec.get("expr")
    if work is None and expr is None:
        raise ValueError(f"block {name}: provide a work callable or an expr")

    out_ports = [p for p in ports if p["direction"] == "output"]
    if work is None:
        _check_torch_expr(expr, name)
    work_fn = work or _make_expr_work(expr, out_ports[0]["id"])

    rate_is_expr = any(c.isalpha() for c in rate_str)

    def __init__(self, name_=None, **overrides):
        Block.__init__(self, name_)
        # Static (compile-time) parameters — the analog of the reference's
        # typekey/vlen descriptor parameters that shape the generated code
        # rather than becoming runtime-settable values: they resolve port
        # shapes and the relative_rate expression, and appear to `expr` as
        # plain Python values (so e.g. `in_[n-1::n]` is a static slice).
        statics: dict[str, int] = {}
        for prm in params:
            if prm.get("static"):
                v = overrides.pop(prm["id"], prm.get("default"))
                if v is None:
                    raise ValueError(f"{name}: static parameter "
                                     f"{prm['id']} needs a value")
                statics[prm["id"]] = int(v)
                setattr(self, prm["id"], statics[prm["id"]])
        self._statics = statics
        val = spec.get("validate")
        if val is not None and not _eval_static(str(val), statics):
            raise ValueError(
                f"{name}: static parameters {statics} violate the "
                f"descriptor constraint {val!r}")
        if rate_is_expr:
            self.relative_rate = Fraction(_eval_static(rate_str, statics,
                                                       frac=True))
        im = spec.get("in_multiple")
        if im is not None:
            # grouping constraint for the compiler's batch sizing (same
            # contract as handwritten blocks' in_multiple attribute);
            # may reference static parameters.
            self.in_multiple = (int(_eval_static(im, statics))
                                if isinstance(im, str) else int(im))
        for p in ports:
            shape = p.get("shape", ()) or ()
            if isinstance(shape, (int, str)):
                shape = [shape]
            vlen = tuple(statics[s] if isinstance(s, str) else int(s)
                         for s in shape)
            if p["direction"] == "input":
                self.add_input(p["id"], port_dtype(p["type"]), vlen)
            else:
                self.add_output(p["id"], port_dtype(p["type"]), vlen)
        for prm in params:
            if prm.get("static"):
                continue
            default = overrides.get(prm["id"], prm.get("default"))
            if default is None:
                raise ValueError(f"{name}: parameter {prm['id']} needs a value")
            self.declare_param(
                prm["id"], default,
                dtype=_DTYPES.get(prm.get("dtype", "float"), np.float32),
                settable=bool(prm.get("settable", True)),
                doc=prm.get("label", ""),
            )

    cls = type(name, (Block,), {
        "__init__": __init__,
        "work": work_fn,
        "relative_rate": rate,
        "__doc__": spec.get("label", name),
        "yaml_spec": spec,
    })
    return cls


_GRC_DTYPE = {
    "cf32": "complex", "rf32": "float", "ri32": "int", "ri16": "short",
    "ru8": "byte",
    # numpy spellings (introspected parameter dtypes)
    "complex64": "complex", "float32": "float", "float64": "real",
    "int32": "int", "int64": "int", "int16": "short", "uint8": "byte",
    "bool": "bool",
}


def grc_yaml(block_or_cls, module: str | None = None) -> str:
    """Render GRC-companion metadata for a block — the reference
    blockbuilder's third output (public header, pybind, **GRC yml**;
    SURVEY.md §3.5). Accepts a class built by block_from_yaml (uses its
    yaml_spec) or any Block instance (introspects ports/params).

    The output follows the GRC 4.0 block-description format: id, label,
    parameters (id/label/dtype/default), inputs/outputs (domain/dtype),
    and a python instantiation template."""
    if isinstance(block_or_cls, type):
        spec = getattr(block_or_cls, "yaml_spec", None)
        if spec is None:
            raise ValueError("class has no yaml_spec; pass an instance instead")
        mod = module or spec.get("module", "newsched_tpu_torch")
        blk = spec["block"]
        params = [{
            "id": p["id"], "label": p.get("label", p["id"]),
            "dtype": _GRC_DTYPE.get(p.get("dtype", "float"), "raw"),
            **({"default": p["default"]} if "default" in p else {}),
        } for p in spec.get("parameters", [])]
        inputs = [{"domain": "stream", "id": p["id"],
                   "dtype": _GRC_DTYPE.get(p["type"], "raw")}
                  for p in spec.get("ports", []) if p["direction"] == "input"]
        outputs = [{"domain": "stream", "id": p["id"],
                    "dtype": _GRC_DTYPE.get(p["type"], "raw")}
                   for p in spec.get("ports", []) if p["direction"] == "output"]
        label = spec.get("label", blk)
    else:
        b = block_or_cls
        mod = module or type(b).__module__.rsplit(".", 1)[-1]
        blk = type(b).__name__
        label = (b.__doc__ or blk).strip().splitlines()[0]
        params = [{
            "id": pid,
            "label": spec.doc or pid,
            "dtype": _GRC_DTYPE.get(np.dtype(spec.dtype).name if spec.dtype else "",
                                    "raw"),
            "default": _plain(b.get_param(pid)),
        } for pid, spec in b._param_specs.items()]
        inputs = [{"domain": "stream", "id": p.name, "dtype": _GRC_DTYPE.get(p.dtype.name, "raw")}
                  for p in b.inputs]
        outputs = [{"domain": "stream", "id": p.name, "dtype": _GRC_DTYPE.get(p.dtype.name, "raw")}
                   for p in b.outputs]

    doc = {
        "id": f"{mod}_{blk}",
        "label": label,
        "category": f"[{mod}]",
        "parameters": params,
        "inputs": inputs,
        "outputs": outputs,
        "templates": {
            "imports": f"from newsched_tpu_torch.blocks import {mod}",
            "make": f"{mod}.{blk}(" + ", ".join(
                f"{p['id']}=${{{p['id']}}}" for p in params) + ")",
        },
        "file_format": 1,
    }
    return _yaml().safe_dump(doc, sort_keys=False)


def _plain(v):
    """YAML-safe scalar for defaults."""
    if isinstance(v, (np.generic, np.ndarray)):
        v = v.item() if np.ndim(v) == 0 else np.asarray(v).tolist()
    if isinstance(v, complex):
        return repr(v)
    return v


def load_module(yaml_dir: str) -> dict[str, type[Block]]:
    """Load every .yml descriptor in a directory (the reference's per-module
    build step)."""
    import glob
    import os

    out = {}
    for path in sorted(glob.glob(os.path.join(yaml_dir, "*.yml"))):
        cls = block_from_yaml(path)
        out[cls.__name__] = cls
    return out
