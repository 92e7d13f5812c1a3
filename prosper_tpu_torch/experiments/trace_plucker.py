"""Counterpart of experiments/trace_plucker.py: the Plücker feature rows
and block, whose plain PyTorch forms live in ops/plucker.py beside the
tensor-core loops that use them (ops/bench_kernels.py)."""

from ..ops.plucker import (  # noqa: F401
    PLU_ROWS,
    plucker_block_plain,
    plucker_rows_from_slab,
    round_tf32,
)
