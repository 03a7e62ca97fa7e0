"""Builtin function registration root: every builtin of the JAX
package's ``register_all``. ``GetAgentStatus`` is not among them there
either; the service layer binds it.

Reference parity: ``src/carnot/funcs/funcs.cc:30`` RegisterFuncsOrDie.
"""

from . import (
    collections,
    conditionals,
    introspection,
    json_ops,
    math_ops,
    math_sketches,
    ml_ops,
    net_ops,
    pii_ops,
    protocol_ops,
    regex_ops,
    request_path_ops,
    sql_ops,
    string_ops,
)


def register_all(reg):
    math_ops.register(reg)
    math_sketches.register(reg)
    conditionals.register(reg)
    collections.register(reg)
    string_ops.register(reg)
    json_ops.register(reg)
    regex_ops.register(reg)
    sql_ops.register(reg)
    ml_ops.register(reg)
    pii_ops.register(reg)
    request_path_ops.register(reg)
    net_ops.register(reg)
    protocol_ops.register(reg)
    introspection.register_introspection(reg)
