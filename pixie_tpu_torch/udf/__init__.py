from .registry import Registry, default_registry
from .udf import Executor, ScalarUDFDef, SignatureError, UDADef, apply_cast, resolve_overload
