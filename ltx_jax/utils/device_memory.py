"""Device memory budgets, read from the device.

Every memory decision in the program (the MemoryConfig preset the CLI
auto-applies, `--model auto`, the serving batch caps, the text-encode chunk)
compares an estimate from shapes with what the device lets this process
allocate: `memory_stats()["bytes_limit"]` (on a GPU, the share of the card
XLA_PYTHON_CLIENT_MEM_FRACTION grants). A device that reports no limit (the
CPU) has no budget: callers then pass one explicitly.
"""

from __future__ import annotations

from typing import Optional

from ltx_jax.core.errors import InvalidConfigurationError


def device_memory_gb(device=None) -> Optional[float]:
    """GB this process may allocate on `device` (default: the first JAX
    device), or None when the device reports no limit."""
    if device is None:
        import jax

        device = jax.devices()[0]
    stats_fn = getattr(device, "memory_stats", None)
    stats = stats_fn() if stats_fn is not None else None
    limit = (stats or {}).get("bytes_limit")
    return limit / 1e9 if limit else None


def memory_budget_gb(budget_gb: Optional[float] = None, device=None) -> float:
    """`budget_gb` when given, else the device's limit. Raises when neither
    exists — there is no default budget."""
    if budget_gb is not None:
        return float(budget_gb)
    limit = device_memory_gb(device)
    if limit is None:
        raise InvalidConfigurationError(
            "the device reports no memory limit; pass a memory budget "
            "explicitly")
    return limit


def tree_gb(tree) -> float:
    """Bytes held by the arrays of a pytree (host or device), in GB."""
    import jax

    return sum(getattr(a, "nbytes", 0) for a in jax.tree.leaves(tree)) / 1e9


def batch_rows_that_fit(budget_gb: float, resident_gb: float,
                        per_row_gb: float, cap: int) -> int:
    """How many batch rows of `per_row_gb` fit beside `resident_gb` in
    `budget_gb`, between 1 and `cap`."""
    free = budget_gb - resident_gb
    if per_row_gb <= 0:
        return cap
    return max(1, min(cap, int(free // per_row_gb)))
