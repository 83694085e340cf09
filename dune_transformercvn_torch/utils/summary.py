"""Model summary: per-module parameter table (RichModelSummary equivalent).

Counterpart of ``dune_transformercvn_tpu/utils/summary.py`` over a module's
``named_parameters()``.  BatchNorm running statistics are buffers here (the
JAX package's ``batch_stats``), so neither side counts them and
:func:`param_count` equals the JAX package's at the same config.
"""

from __future__ import annotations

from typing import Dict

from torch import nn


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def summarize_params(model: nn.Module, max_depth: int = 2) -> str:
    """Render a parameter-count table grouped to ``max_depth`` module levels."""
    table: Dict[str, int] = {}
    for name, p in model.named_parameters():
        group = ".".join(name.split(".")[:max_depth])
        table[group] = table.get(group, 0) + p.numel()
    total = sum(table.values())
    width = max((len(k) for k in table), default=10)
    lines = ["-" * (width + 16)]
    lines += [f"{name:<{width}}  {count:>12,}" for name, count in sorted(table.items())]
    lines.append("-" * (width + 16))
    lines.append(f"{'total':<{width}}  {total:>12,}")
    return "\n".join(lines)
