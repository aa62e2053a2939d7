"""Write the port's op-binding surface from `paddle_tpu_torch/ops/ops.yaml`.

Twin of `tools/gen_op_bindings.py`: every entry of the port's manifest
becomes a def in `paddle_tpu_torch/ops/generated_bindings.py` with the
YAML signature, so unknown keywords and wrong arity fail there with a
TypeError naming the op; `_C_ops`, the Tensor methods and the top-level
op names are built from that module. A registered op resolves from the
registry at call time. An op that another item of the port brings
(`ops/kernels/_util.py` `WAITING`) gets a def that raises `WaitingOp`
naming the item.

Run: python tools/gen_op_bindings_torch.py [--check]
(--check exits 1 when the committed file differs from a fresh one)
"""
from __future__ import annotations

import ast
import importlib
import importlib.util
import os
import pkgutil
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OUT_PATH = os.path.join(ROOT, "paddle_tpu_torch", "ops",
                        "generated_bindings.py")

HEADER = '''\
"""Generated from ops/ops.yaml by tools/gen_op_bindings_torch.py; do not
edit. Regenerate with: python tools/gen_op_bindings_torch.py

One def per manifest entry, carrying the manifest's signature: unknown
keywords and wrong arity fail here with a TypeError naming the op,
before the op runs. `paddle_tpu_torch._C_ops`, the Tensor methods and
the top-level op names are built from this module. A registered op
resolves from the registry at call time; an op that another item of
the port brings raises `WaitingOp` naming the item.
"""
from math import inf, nan  # noqa: F401  (signature defaults)

from .dispatch import OPS as _OPS
from .kernels._util import waiting_error as _waiting_error

'''


def _forward_call(args_src: str) -> str:
    """The forwarding argument list of a manifest signature."""
    a = ast.parse(f"def f{args_src}: pass").body[0].args
    parts = []
    ordered = list(a.posonlyargs) + list(a.args)
    npos = len(ordered) - len(a.defaults)
    for i, arg in enumerate(ordered):
        parts.append(arg.arg if i < npos else f"{arg.arg}={arg.arg}")
    if a.vararg:
        parts.append(f"*{a.vararg.arg}")
    parts += [f"{arg.arg}={arg.arg}" for arg in a.kwonlyargs]
    if a.kwarg:
        parts.append(f"**{a.kwarg.arg}")
    return ", ".join(parts)


def _load(relpath: str, name: str):
    """A module of the port loaded from its file, outside the package:
    importing `paddle_tpu_torch.ops.generated_bindings` itself must not be
    needed to regenerate it."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "paddle_tpu_torch", *relpath.split("/")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _waiting() -> dict:
    """{name: item} of the ops that wait for another item of the port:
    every kernel module is imported, since each registers its own."""
    sys.path.insert(0, ROOT)
    import paddle_tpu_torch.ops.kernels as K
    for info in pkgutil.iter_modules(K.__path__):
        importlib.import_module(f"{K.__name__}.{info.name}")
    from paddle_tpu_torch.ops.kernels._util import WAITING
    return {n: f._waiting_item for n, f in WAITING.items()}


def generate() -> str:
    manifest = _load("ops/schema.py", "_port_ops_schema").load_manifest()
    waiting = _waiting()
    chunks = [HEADER]
    for name in sorted(manifest):
        args_src = manifest[name]["args"]
        if name in waiting:
            body = f"raise _waiting_error({name!r})  # item {waiting[name]}"
        else:
            body = f"return _OPS[{name!r}]({_forward_call(args_src)})"
        chunks.append(f"def {name}{args_src}:\n    {body}\n\n")
    chunks.append("\nWAITING = [\n" + "".join(
        f"    {n!r},\n" for n in sorted(waiting) if n in manifest) + "]\n")
    chunks.append("\n__all__ = [\n" + "".join(
        f"    {n!r},\n" for n in sorted(manifest)) + "]\n")
    return "\n".join(chunks)


def main(check: bool = False) -> int:
    src = generate()
    if check:
        with open(OUT_PATH) as f:
            if f.read() != src:
                print("generated_bindings.py is stale: run "
                      "python tools/gen_op_bindings_torch.py", file=sys.stderr)
                return 1
        print("generated_bindings.py is current")
        return 0
    with open(OUT_PATH, "w") as f:
        f.write(src)
    print(f"{src.count(chr(10) + 'def ')} bindings -> {OUT_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main(check="--check" in sys.argv))
