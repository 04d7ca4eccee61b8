"""Rectangular linear sum assignment with scipy's tie rules, batched.

Port of deepdish_tpu/ops/assignment.py (`_solve_ascending` :41,
`solve_lsap` :155). The tracker's crossing counts need byte-identical
assignments, so this is the same shortest-augmenting-path algorithm as
`scipy.optimize.linear_sum_assignment` (Crouse, IEEE TAES 2016) with the same
tie-breaking:

  * rows are augmented in ascending order;
  * the Dijkstra frontier scans the columns in an order that starts
    descending and loses each pick by swap-with-last removal (kept here,
    as in the kernel, as a scan position per column);
  * among tied minimum reduced costs the first scan position wins, unless a
    tied column is unmatched; then the last tied unmatched position wins;
  * a wide matrix (n_rows > n_cols) is solved transposed and the result
    inverted.

Arithmetic is float32, relaxing as ((min_val + cost) - u) - v, exactly as
the JAX solver and the CUDA kernel (csrc/lsap.cu) do. The tracker clamps
costs to max_distance + 1e-5 before solving, so reduced costs stay O(1) and
float32 resolves the same ties scipy sees in float64.

`solve_lsap(costs, sizes)` is the entry; in this reference it is always the
plain version below, on the host.
"""
from __future__ import annotations

import torch


_INT_MAX = 2 ** 31 - 1


def order_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 key of float32 values, as csrc/lsap.cu
    `order_key` computes it: -0.0 and +0.0 share a key (they tie under
    ==), negatives flip their low 31 bits, so -inf < finite < +inf keep
    their order. NaN is not a cost."""
    bits = torch.where(x == 0, 0.0, x).float().contiguous().view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def key_value(key: torch.Tensor) -> torch.Tensor:
    """The float32 value of an `order_key` (+0.0 for a zero)."""
    return torch.where(key >= 0, key, key ^ 0x7FFFFFFF).view(torch.float32)


def scan_pick(key: torch.Tensor, pos: torch.Tensor, live: torch.Tensor,
              matched: torch.Tensor, tie: int):
    """scipy's argmin over a Dijkstra scan, as two reductions over columns
    (the kernel's two `redux.sync`). key, pos (scan position), live (in the
    scan) and matched are (B, K); tie > every position. Returns (lowest
    key, picked position): among the columns with the lowest key the first
    position wins, unless one is unmatched, then the last unmatched one.
    One max does it: tied unmatched columns score tie + pos, tied matched
    ones tie - 1 - pos. Rows with no live column give (INT_MAX, tie)."""
    key = torch.where(live, key, _INT_MAX)
    lowest = key.amin(1)
    tied = live & (key == lowest[:, None])
    best = torch.where(tied, torch.where(matched, tie - 1 - pos, tie + pos),
                       -1).amax(1)
    return lowest, torch.where(best >= tie, best - tie, tie - 1 - best)


def solve_lsap_plain(costs: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch solve of a batch. costs (B, K, K) float32 capacity-padded
    matrices, sizes (B, 2) int (n_rows, n_cols). Returns (B, K) int32 row ->
    col, -1 for unassigned rows (every row >= n_rows included).

    The formulation is the CUDA kernel's: a scan position per column in
    place of the `remaining` list (the pick leaves, the column at the last
    position takes its place), the argmin as `scan_pick`, the row duals
    updated through col2row of the picked columns. The B problems advance
    in lockstep with per-lane masks (the batched form of the JAX `vmap`ped
    while loops); loop exits read the device, so this version is for the
    CPU and for checking the kernel, not for speed."""
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
    in_cols = ids[None] < n_cols[:, None]

    u = torch.zeros((B, K), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    row2col = torch.full((B, K), -1, dtype=torch.long, device=dev)
    col2row = torch.full_like(row2col, -1)

    max_rows = int(n_rows.max()) if B else 0
    for cur_row in range(max_rows):
        en = cur_row < n_rows
        spc = torch.full((B, K), float("inf"), device=dev)
        path = torch.full((B, K), -1, dtype=torch.long, device=dev)
        pos = torch.where(in_cols, n_cols[:, None] - 1 - ids[None], -1)
        num_rem = n_cols.clone()
        i = torch.full((B,), cur_row, dtype=torch.long, device=dev)
        min_val = torch.zeros((B,), device=dev)
        sink = torch.where(en, -1, 0)

        while True:
            act = (sink < 0) & (num_rem > 0)
            if not bool(act.any()):
                break
            live = act[:, None] & (pos >= 0)
            r = ((min_val[:, None] + cost[b_ids, i]) -
                 u.gather(1, i[:, None])) - v
            better = live & (r < spc)
            spc = torch.where(better, r, spc)
            path = torch.where(better, i[:, None], path)

            lowest, idx = scan_pick(order_key(spc), pos, live, col2row >= 0,
                                    K)
            hit = live & (pos == idx[:, None])
            j = torch.where(hit, ids[None], -1).amax(1)
            c2r_j = torch.where(hit, col2row, -1).amax(1)
            last = act[:, None] & (pos == (num_rem - 1)[:, None])
            pos = torch.where(hit, -1, torch.where(last, idx[:, None], pos))
            num_rem = torch.where(act, num_rem - 1, num_rem)
            min_val = torch.where(act, key_value(lowest), min_val)
            is_sink = c2r_j < 0
            sink = torch.where(act & is_sink, j, sink)
            i = torch.where(act & ~is_sink, c2r_j, i)

        # dual updates: the picked columns, and the rows the matched ones
        # brought into the scan
        picked = en[:, None] & in_cols & (pos < 0)
        d = min_val[:, None] - spc
        du = torch.zeros((B, K + 1), device=dev)
        du.scatter_(1, torch.where(picked & (col2row >= 0), col2row, K),
                    torch.where(picked, d, 0.0))
        du[:, cur_row] = torch.where(en, min_val, 0.0)
        u = u + du[:, :K]
        v = v - torch.where(picked, d, 0.0)

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

    # a transposed solve's rows are the original columns: its col2row is
    # the original row -> column map
    out = torch.where(transposed[:, None], col2row, row2col)
    return out.to(torch.int32)


def solve_lsap(costs: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """(B, K, K) float32 costs, (B, 2) int32 sizes -> (B, K) int32 on the
    costs' device, solved by the plain solver on the host (its loop reads
    its state every step, which on a card would wait on the card each
    time)."""
    return solve_lsap_plain(costs.cpu(), sizes.cpu()).to(costs.device)
