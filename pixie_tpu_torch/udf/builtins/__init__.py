"""Builtin function registration root (the subset this slice binds).

Reference parity: ``src/carnot/funcs/funcs.cc:30`` RegisterFuncsOrDie.
"""

from . import collections, json_ops, math_ops, math_sketches


def register_all(reg):
    math_ops.register(reg)
    math_sketches.register(reg)
    collections.register(reg)
    json_ops.register(reg)
