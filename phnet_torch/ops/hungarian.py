"""Batched minimum-cost assignment (Jonker-Volgenant), on the device.

Port of ``phnet_tpu/ops/hungarian.py``: the shortest-augmenting-path
solver that ``scipy.optimize.linear_sum_assignment`` runs, for many small
problems at once and with no host sync. The JAX package runs it in
``lax.while_loop``s; eager PyTorch has no device-side loop, so the loops
are bounded instead. Augmenting row ``r`` (0-based) meets at most ``r``
assigned columns before it reaches a free one, so its Dijkstra search
takes at most ``r + 1`` steps and its alternating path flips at most
``r + 1`` columns: with R rows, ``R (R + 1) / 2`` steps of each, all
problems in lockstep and each finished problem masked.

The arithmetic is JAX's, in its order (``min_val + cost[i] - u[i] - v``),
and ties go to the first index of the minimum (``torch.argmin`` and
``jnp.argmin`` agree), so ``col4row`` is bit-equal to the JAX solver's on
the same costs, the invalid rows' columns included. Plain PyTorch, no
kernel: it runs as a few hundred small launches a solve on the card.
"""

from __future__ import annotations

import torch


def hungarian_assign(cost: torch.Tensor, row_valid: torch.Tensor
                     ) -> torch.Tensor:
    """Minimum-cost assignment of each valid row to a distinct column, for
    every problem of a batch.

    cost: ``[N, R, C]`` float, R <= C; row_valid: ``[N, R]`` bool. An
    invalid row's costs are replaced by zeros, which leaves the valid rows'
    optimum as it is, and it gets an arbitrary distinct column. Returns
    ``col4row`` ``[N, R]`` int64. Shows as the range
    ``hungarian_assign`` in a ``torch.profiler`` trace."""
    with torch.profiler.record_function("hungarian_assign"):
        return _solve(cost, row_valid)


def _solve(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    n, r, c = cost.shape
    if r > c:
        raise ValueError(f"hungarian_assign: {r} rows > {c} columns")
    dev = cost.device
    cost = torch.where(row_valid[..., None], cost,
                       torch.zeros((), device=dev)).float()
    inf = torch.full((), float("inf"), device=dev)
    ar = torch.arange(n, device=dev)
    rows = torch.arange(r, device=dev)
    cols = torch.arange(c, device=dev)
    u = torch.zeros((n, r), device=dev)
    v = torch.zeros((n, c), device=dev)
    col4row = torch.full((n, r), -1, dtype=torch.long, device=dev)
    row4col = torch.full((n, c), -1, dtype=torch.long, device=dev)
    for cur in range(r):
        shortest = torch.full((n, c), float("inf"), device=dev)
        path = torch.full((n, c), -1, dtype=torch.long, device=dev)
        visited = torch.zeros((n, c), dtype=torch.bool, device=dev)
        scanned = torch.zeros((n, r), dtype=torch.bool, device=dev)
        i = torch.full((n,), cur, dtype=torch.long, device=dev)
        sink = torch.full((n,), -1, dtype=torch.long, device=dev)
        min_val = torch.zeros((n,), device=dev)
        for _ in range(cur + 1):  # Dijkstra until a free column is reached
            active = sink < 0
            scanned = scanned | (active[:, None] & (rows == i[:, None]))
            reduced = (min_val[:, None] + cost[ar, i] - u[ar, i][:, None]
                       - v)
            better = (reduced < shortest) & ~visited & active[:, None]
            shortest = torch.where(better, reduced, shortest)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(visited, inf, shortest)
            j = torch.argmin(masked, dim=1)
            visited = visited | (active[:, None] & (cols == j[:, None]))
            nxt = row4col[ar, j]
            free = nxt < 0
            min_val = torch.where(active, masked[ar, j], min_val)
            sink = torch.where(active & free, j, sink)
            i = torch.where(active & ~free, nxt, i)
        # dual potentials (scipy's _lsap.c)
        u = torch.where(rows == cur, u + min_val[:, None], u)
        others = scanned & (rows != cur)
        u = torch.where(others,
                        u + min_val[:, None]
                        - torch.gather(shortest, 1, col4row.clamp(0, c - 1)),
                        u)
        v = torch.where(visited, v + shortest - min_val[:, None], v)
        # augment along the alternating path that ends at the sink
        j = sink
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        for _ in range(cur + 1):
            active = ~done
            jc = j.clamp(min=0)
            i = path[ar, jc].clamp(min=0)
            row4col[ar, jc] = torch.where(active, i, row4col[ar, jc])
            prev_j = col4row[ar, i]
            col4row[ar, i] = torch.where(active, jc, prev_j)
            done = done | (active & (i == cur))
            j = torch.where(active, prev_j, j)
    return col4row
