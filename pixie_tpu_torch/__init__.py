"""pixie_tpu_torch: the PyTorch/CUDA port of pixie_tpu.

The same query engine (PxL frontend, table store with device-resident
windows, pipelined windowed group-by fold) with plain PyTorch around two
hand-written Hopper kernels (``csrc/``). It imports neither JAX nor the
JAX package. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""

from .exec.engine import Engine, QueryCancelled, QueryError

__all__ = ["Engine", "QueryCancelled", "QueryError"]
