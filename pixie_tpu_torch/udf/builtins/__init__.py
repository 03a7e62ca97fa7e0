"""Builtin function registration root (the subset this slice binds).

Reference parity: ``src/carnot/funcs/funcs.cc:30`` RegisterFuncsOrDie.
"""

from . import json_ops, math_ops, math_sketches


def register_all(reg):
    math_ops.register(reg)
    math_sketches.register(reg)
    json_ops.register(reg)
