"""Rectangular linear sum assignment with scipy's tie rules, batched.

Port of deepdish_tpu/ops/assignment.py (`_solve_ascending` :41,
`solve_lsap` :155). The tracker's crossing counts need byte-identical
assignments, so this is the same shortest-augmenting-path algorithm as
`scipy.optimize.linear_sum_assignment` (Crouse, IEEE TAES 2016) with the same
tie-breaking:

  * rows are augmented in ascending order;
  * the Dijkstra frontier scans the `remaining` column list, which starts in
    descending column order and loses entries by swap-with-last removal;
  * among tied minimum reduced costs the first scan position wins, unless a
    tied column is unmatched; then the last tied unmatched position wins;
  * a wide matrix (n_rows > n_cols) is solved transposed and the result
    inverted.

Arithmetic is float32, relaxing as ((min_val + cost) - u) - v, exactly as
the JAX solver and the CUDA kernel (csrc/lsap.cu) do. The tracker clamps
costs to max_distance + 1e-5 before solving, so reduced costs stay O(1) and
float32 resolves the same ties scipy sees in float64.

`solve_lsap(costs, sizes)` is the entry: a CPU tensor goes to the plain
version below, a CUDA tensor to the hand-written kernel
(kernels/lsap.py), which raises on anything it cannot take.
"""
from __future__ import annotations

import torch


def solve_lsap_plain(costs: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch solve of a batch. costs (B, K, K) float32 capacity-padded
    matrices, sizes (B, 2) int (n_rows, n_cols). Returns (B, K) int32 row ->
    col, -1 for unassigned rows (every row >= n_rows included).

    The B problems advance in lockstep with per-lane masks (the batched form
    of the JAX `vmap`ped while loops); loop exits read the device, so this
    version is for the CPU and for checking the kernel, not for speed."""
    B, K, K2 = costs.shape
    if K != K2:
        raise ValueError("solve_lsap needs square (B, K, K) capacity matrices")
    dev = costs.device
    costs = costs.float()
    ids = torch.arange(K, device=dev)
    nr0 = sizes[:, 0].long().clamp(0, K)
    nc0 = sizes[:, 1].long().clamp(0, K)
    transposed = nr0 > nc0
    n_rows = torch.minimum(nr0, nc0)
    n_cols = torch.maximum(nr0, nc0)
    cost = torch.where(transposed[:, None, None], costs.transpose(1, 2),
                       costs)
    b_ids = torch.arange(B, device=dev)

    u = torch.zeros((B, K), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    row2col = torch.full((B, K), -1, dtype=torch.long, device=dev)
    col2row = torch.full_like(row2col, -1)
    inf = torch.tensor(float("inf"), device=dev)

    max_rows = int(n_rows.max()) if B else 0
    for cur_row in range(max_rows):
        en = cur_row < n_rows
        spc = torch.full((B, K), float("inf"), device=dev)
        path = torch.full((B, K), -1, dtype=torch.long, device=dev)
        sr = torch.zeros((B, K), dtype=torch.bool, device=dev)
        sc = torch.zeros_like(sr)
        remaining = torch.where(ids[None] < n_cols[:, None],
                                n_cols[:, None] - 1 - ids[None],
                                torch.zeros_like(ids)[None])
        num_rem = n_cols.clone()
        i = torch.full((B,), cur_row, dtype=torch.long, device=dev)
        min_val = torch.zeros((B,), device=dev)
        sink = torch.where(en, -1, 0)

        while True:
            act = (sink < 0) & (num_rem > 0)
            if not bool(act.any()):
                break
            sr = sr | (act[:, None] & (ids[None] == i[:, None]))
            in_rem = act[:, None] & ~sc & (ids[None] < n_cols[:, None])
            r = ((min_val[:, None] + cost[b_ids, i]) -
                 u.gather(1, i[:, None])) - v
            better = in_rem & (r < spc)
            spc = torch.where(better, r, spc)
            path = torch.where(better, i[:, None], path)

            it_valid = ids[None] < num_rem[:, None]
            c_at = torch.where(it_valid, spc.gather(1, remaining), inf)
            lowest = c_at.amin(1)
            tied = it_valid & (c_at == lowest[:, None])
            unmatched = tied & (col2row.gather(1, remaining) < 0)
            first_tied = torch.where(tied, ids[None], K).amin(1)
            last_unm = torch.where(unmatched, ids[None], -1).amax(1)
            idx = torch.where(unmatched.any(1), last_unm,
                              first_tied).clamp(0, K - 1)
            j = remaining.gather(1, idx[:, None])[:, 0]
            last_rem = remaining.gather(
                1, (num_rem - 1).clamp(min=0)[:, None])[:, 0]
            remaining = torch.where(act[:, None] & (ids[None] == idx[:, None]),
                                    last_rem[:, None], remaining)
            num_rem = torch.where(act, num_rem - 1, num_rem)
            sc = sc | (act[:, None] & (ids[None] == j[:, None]))
            min_val = torch.where(act, lowest, min_val)
            c2r_j = col2row.gather(1, j[:, None])[:, 0]
            is_sink = c2r_j < 0
            sink = torch.where(act & is_sink, j, sink)
            i = torch.where(act & ~is_sink, c2r_j, i)

        # dual updates
        spc_r2c = spc.gather(1, row2col.clamp(min=0))
        du = torch.where(sr & (ids[None] != cur_row),
                         min_val[:, None] - spc_r2c,
                         torch.where(ids[None] == cur_row, min_val[:, None],
                                     0.0))
        u = u + torch.where(en[:, None], du, 0.0)
        v = v - torch.where(en[:, None] & sc, min_val[:, None] - spc, 0.0)

        # augment along the alternating path
        j = sink
        done = ~en | (sink < 0)
        while not bool(done.all()):
            act = ~done
            i = path.gather(1, j.clamp(min=0)[:, None])[:, 0]
            col2row = torch.where(act[:, None] & (ids[None] == j[:, None]),
                                  i[:, None], col2row)
            old = row2col.gather(1, i.clamp(min=0)[:, None])[:, 0]
            row2col = torch.where(act[:, None] & (ids[None] == i[:, None]),
                                  j[:, None], row2col)
            j = torch.where(act, old, j)
            done = done | (i == cur_row) | (i < 0)

    # a transposed solve's rows are the original columns: invert
    inv = torch.full((B, K + 1), -1, dtype=torch.long, device=dev)
    dest = torch.where(row2col >= 0, row2col, K)
    inv.scatter_(1, dest, ids[None].expand(B, K).contiguous())
    out = torch.where(transposed[:, None], inv[:, :K], row2col)
    return out.to(torch.int32)


def solve_lsap(costs: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """(B, K, K) float32 costs, (B, 2) int32 sizes -> (B, K) int32.

    CPU tensors take the plain version; CUDA tensors the CUDA kernel, which
    raises rather than fall back."""
    if costs.device.type == "cpu":
        return solve_lsap_plain(costs, sizes)
    from ..kernels import lsap
    return lsap.solve(costs, sizes)

