"""The port's scalar math UDFs against the JAX package's, overload by
overload, on the CPU: planes of FLOAT64 (f32 on the device), INT64 and
TIME64NS values from a seed, with zeros, negatives and non-finite
values, and a literal (Python scalar) second argument where the planner
passes one (``px.bin(df.time_, px.DurationNanos(...))``). Integer and
boolean results are exact; float results within rtol 1e-6 (one f32
ulp is about 1.2e-7; XLA:CPU and PyTorch round ``exp``, ``log`` and
``pow`` independently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixie_tpu.types.dtypes import DataType as JaxDataType
from pixie_tpu.udf.registry import default_registry as jax_registry
from pixie_tpu_torch.types import DataType
from pixie_tpu_torch.udf.registry import default_registry

N = 257


def _plane(dt: str, seed: int):
    rng = np.random.default_rng(seed)
    if dt == "FLOAT64":
        v = rng.normal(0, 50, N).astype(np.float32)
        v[:6] = [0.0, -0.0, 1.0, -1.5, 2.5, np.inf]
        return v
    if dt == "BOOLEAN":
        return rng.integers(0, 2, N).astype(bool)
    v = rng.integers(-(1 << 40), 1 << 40, N)
    v[:4] = [0, -7, 7, 3_000_000_001]
    return v


POSITIVE = {"sqrt", "ln", "log2", "log10", "log"}

CASES = [
    ("modulo", ("INT64", "INT64")),
    ("pow", ("FLOAT64", "FLOAT64")),
    ("approxEqual", ("FLOAT64", "FLOAT64")),
    ("invert", ("BOOLEAN",)),
    ("abs", ("INT64",)), ("abs", ("FLOAT64",)),
    ("negate", ("INT64",)), ("negate", ("FLOAT64",)),
    ("ceil", ("FLOAT64",)), ("floor", ("FLOAT64",)), ("round", ("FLOAT64",)),
    ("sqrt", ("FLOAT64",)), ("exp", ("FLOAT64",)), ("ln", ("FLOAT64",)),
    ("log2", ("FLOAT64",)), ("log10", ("FLOAT64",)),
    ("log", ("FLOAT64", "FLOAT64")),
    ("bin", ("INT64", "INT64")), ("bin", ("TIME64NS", "INT64")),
    ("time_to_int64", ("TIME64NS",)), ("int64_to_time", ("INT64",)),
]


def _args(name, types):
    args = []
    for i, t in enumerate(types):
        p = _plane(t, 7 * i + len(name))
        if name in POSITIVE or (name == "pow" and i == 0):
            p = np.abs(p) + np.float32(0.5)
        if name == "pow" and i == 1:
            p = np.clip(p, -3, 3)
        if name == "exp":
            p = np.clip(p, -60, 60)
        if name in ("modulo", "bin") and i == 1:
            p = p % 1000 - 300  # small divisors, zeros and negatives
            p[:3] = [0, 1, -1]
        args.append(p)
    if name == "approxEqual":
        args[1] = args[0] + np.float32(5e-5) * (np.arange(N) % 3)
    return args


def _compare(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,types", CASES,
                         ids=[f"{n}-{'-'.join(t)}" for n, t in CASES])
def test_scalar_udf_matches_jax(name, types):
    ref_udf = jax_registry().get_scalar(
        name, [JaxDataType[t] for t in types])
    udf = default_registry().get_scalar(name, [DataType[t] for t in types])
    assert udf.return_type.name == ref_udf.return_type.name
    args = _args(name, types)
    want = ref_udf.fn(*(jnp.asarray(a) for a in args))
    _compare(udf.fn(*(torch.from_numpy(a) for a in args)), want)
    if len(types) == 2 and name not in ("approxEqual",):
        # A literal second argument, as the planner binds one.
        lit = 1_000_000_000 if name == "bin" else (
            3 if types[1] == "INT64" else 2.0)
        want = ref_udf.fn(jnp.asarray(args[0]), lit)
        _compare(udf.fn(torch.from_numpy(args[0]), lit), want)
