"""Linear sum assignment (Jonker-Volgenant shortest augmenting path), batched.

Counterpart of fiery_tpu/ops/lap.py. The instance tracker solves one small dense
assignment per frame step; the ``lap`` kernel (csrc/lap.cu) solves a batch of them
on the card, one warp per problem, reading the number of rows to augment from
device memory so that the tracker never waits on the host.

Both versions follow the JAX solver's rules exactly:
  * reduced cost ``r = ((minval + cost[i]) - u[i]) - v`` in f32;
  * among tied minima, an unassigned column first, then the lowest index;
  * duals updated over the visited rows and columns with ``col4row`` read before
    the augmentation;
  * rows ``>= n_rows`` are not augmented and get -1.
Pad invalid pairs with a large finite cost, as the tracker does. Past the JAX
solver, which takes finite costs only: a search whose least reduced cost is not
finite (a row of infinite or NaN costs) finds no augmenting path, and its row
stays unassigned (-1) with the duals unchanged.
"""

import ctypes
import functools

import torch

from fiery_tpu_torch.ops import _build

_INF = float('inf')


def _solve_one(cost, n_rows):
    """JV on one (n, n) f32 matrix; returns (col4row int64 (n,), Dijkstra steps)."""
    n = cost.shape[0]
    dev = cost.device
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    row4col = torch.full((n,), -1, dtype=torch.int64, device=dev)
    col4row = torch.full((n,), -1, dtype=torch.int64, device=dev)
    steps = 0
    for cur_row in range(n_rows):
        SR = torch.zeros(n, dtype=torch.bool, device=dev)
        SC = torch.zeros(n, dtype=torch.bool, device=dev)
        spc = torch.full((n,), _INF, dtype=torch.float32, device=dev)
        path = torch.full((n,), -1, dtype=torch.int64, device=dev)
        minval = torch.zeros((), dtype=torch.float32, device=dev)
        i, sink = cur_row, -1
        for _ in range(n):          # each step adds a column: n steps at most
            steps += 1
            SR[i] = True
            r = ((minval + cost[i]) - u[i]) - v
            upd = ~SC & (r < spc)
            spc = torch.where(upd, r, spc)
            path = torch.where(upd, torch.full_like(path, i), path)
            cand = torch.where(SC, torch.full_like(spc, _INF), spc)
            lowest = cand.min()
            if not bool(torch.isfinite(lowest)):
                break               # no finite augmenting path: the row stays unassigned
            tie = cand == lowest
            free_tie = tie & (row4col < 0)
            pick = free_tie if bool(free_tie.any()) else tie
            j = int(pick.to(torch.int32).argmax())
            SC[j] = True
            minval = lowest
            if int(row4col[j]) < 0:
                sink = j
                break
            i = int(row4col[j])
        if sink < 0:
            continue
        on_row = torch.arange(n, device=dev) == cur_row
        spc_of_row = spc[col4row.clamp(0, n - 1)]
        u = torch.where(SR, torch.where(on_row, u + minval, (u + minval) - spc_of_row), u)
        v = torch.where(SC, v - (minval - spc), v)
        j = sink
        while True:
            i = int(path[j])
            row4col[j] = i
            nxt = int(col4row[i])
            col4row[i] = j
            if i == cur_row:
                break
            j = nxt
    return col4row, steps


def linear_sum_assignment_plain(cost, n_rows=None):
    """Plain version of ``linear_sum_assignment``: the same algorithm as a Python
    loop over rows and Dijkstra steps (it reads ``n_rows`` and its own state on the
    host). Sets ``linear_sum_assignment_plain.steps`` to the number of Dijkstra steps
    taken over the batch."""
    B, n, _ = cost.shape
    cost = cost.float()
    rows = [n] * B if n_rows is None else [min(max(int(r), 0), n) for r in n_rows]
    out, steps = [], 0
    for b in range(B):
        col4row, s = _solve_one(cost[b], rows[b])
        out.append(col4row)
        steps += s
    linear_sum_assignment_plain.steps = steps
    return torch.stack(out).to(torch.int32)


linear_sum_assignment_plain.steps = 0


@functools.cache
def _lap_fn():
    """fiery_lap of the lap library, typed once."""
    fn = _build.load('lap').fiery_lap
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def linear_sum_assignment(cost, n_rows=None):
    """col4row (B, n) int32: for each row the assigned column, minimising the total
    cost of each (n, n) problem of ``cost`` (B, n, n) float32 (kernel K9, csrc/lap.cu).

    n_rows (optional): int32 (B,) on the device of ``cost``; only rows [0, n_rows[b])
    of problem b are augmented, the others get -1 (exact for a padded problem whose
    skipped rows cost the same in every column, as in fiery_tpu/ops/lap.py). A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, which reads
    n_rows on the device.
    """
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2]:
        raise ValueError(f'linear_sum_assignment: cost {tuple(cost.shape)} must be (B, n, n)')
    B, n, _ = cost.shape
    if n_rows is not None and tuple(n_rows.shape) != (B,):
        raise ValueError(f'linear_sum_assignment: n_rows {tuple(n_rows.shape)} must be ({B},)')
    if cost.device.type == 'cpu':
        return linear_sum_assignment_plain(cost, n_rows)
    if cost.device.type != 'cuda' or (n_rows is not None and n_rows.device != cost.device):
        raise ValueError(f'linear_sum_assignment: cost on {cost.device}, n_rows on '
                         f'{None if n_rows is None else n_rows.device}')
    if cost.dtype != torch.float32 or (n_rows is not None and n_rows.dtype != torch.int32):
        raise TypeError('linear_sum_assignment: cost must be float32 and n_rows int32')
    if not (1 <= n <= 1024):
        raise ValueError(f'linear_sum_assignment: n = {n}, the kernel takes 1 <= n <= 1024')
    cost = cost.contiguous()
    if n_rows is None:
        n_rows = torch.full((B,), n, dtype=torch.int32, device=cost.device)
    n_rows = n_rows.contiguous()
    fn = _lap_fn()
    col4row = torch.empty((B, n), dtype=torch.int32, device=cost.device)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    rc = fn(cost.data_ptr(), n_rows.data_ptr(), col4row.data_ptr(), B, n, stream)
    if rc != 0:
        raise RuntimeError(f'lap kernel launch failed: CUDA error {rc}')
    linear_sum_assignment.launches += 1
    return col4row


linear_sum_assignment.launches = 0
