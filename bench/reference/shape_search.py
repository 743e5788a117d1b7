"""The shape search of one controller step (paper §3.3), plain PyTorch:

  shape_search  resize_shape(evolve_shape(prev), target=max_cells): the
                head/tail swap loop (or the 1-member drift/jump), then
                grow/shrink to the budgeted cell count
  budget_walk   drop cells (first_removable) until the induced-MST
                preorder walk of each camera fits its exploration budget

The plain versions are masked fleet-batch loops: every mask is [F, N]
bool, per-camera scalars are [F]. The data-dependent loops run as Python
loops under a static bound guaranteed by the algorithm, with per-camera
`done` masks turning finished cameras' iterations into no-ops, and stop
once every camera is done (one host read per iteration). A flood fill
inside a shape grows its reached set one hop per iteration until it
stops changing; the induced-MST walk's
components come from a log-doubling transitive closure (ceil(log2 N)
squarings); the "first removable member" probe tests all members'
removals at once and picks the first in label order.

Tie-breaking is the reference's: stable sorts break toward the lower
cell id; argmax/argmin return the first extremum.
"""
from __future__ import annotations

import math

import torch

from bench.reference.neighbor_score import neighbor_scores

INF = math.inf


def _onehot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[...] int -> [..., n] bool."""
    return torch.nn.functional.one_hot(idx, n).bool()


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none)."""
    return torch.argmax(x.to(torch.uint8), dim=-1)


def _scores(statics, mask, has_boxes, centroids, head):
    return neighbor_scores(mask, has_boxes, centroids, head,
                           statics.d_center, statics.overlap,
                           statics.cell_x, statics.cell_y,
                           statics.neighbor8)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [F, N], idx [F] -> x[f, idx[f]]."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


# ---------------------------------------------------------------------------
# contiguity (8-connected)
# ---------------------------------------------------------------------------

def reach_closure(mask: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """[..., N] mask + [N, N] (or [..., N, N]) adjacency -> [..., N, N]
    bool: r[..., i, j] = j is reachable from i inside `mask` (reflexive
    on every cell). Log-doubling: after k squarings the closure covers
    paths of up to 2**k hops, and ceil(log2 N) squarings cover any path
    of a shape of N cells."""
    n = mask.shape[-1]
    inside = mask[..., :, None] & mask[..., None, :]
    eye = torch.eye(n, dtype=torch.bool, device=mask.device)
    r = ((adj & inside) | eye).to(torch.float32)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        r = (torch.matmul(r, r) > 0).to(torch.float32)
    return r > 0


def flood_reach(mask: torch.Tensor, seed: torch.Tensor,
                adj: torch.Tensor) -> torch.Tensor:
    """Cells of `mask` reachable from `seed` (both [..., N] bool) over the
    [N, N] adjacency: the reached set grows by one hop per iteration
    until it stops changing (a path inside the mask has at most N - 1
    hops)."""
    adj_f = adj.to(torch.float32)
    reach = seed & mask
    for _ in range(mask.shape[-1] - 1):
        grown = mask & (reach | (torch.matmul(reach.to(torch.float32),
                                              adj_f) > 0))
        if torch.equal(grown, reach):
            break
        reach = grown
    return reach


def is_contiguous(mask: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """[..., N] bool -> [...] bool (empty / singleton masks are
    contiguous)."""
    n = mask.shape[-1]
    reach = flood_reach(mask, _onehot(_first_true(mask), n), adj)
    return torch.all(~mask | reach, dim=-1)


def first_removable(mask: torch.Tensor, labels: torch.Tensor,
                    adj: torch.Tensor) -> torch.Tensor:
    """Lowest-label member whose removal keeps the shape 8-connected,
    falling back to the lowest-label member outright. Returns [F].

    Every member's removal is tested at once ([F, N, N] trial masks); the
    pick is the first success in ascending-label order (ties toward the
    lower cell id) — the reference probes the same order one by one."""
    f, n = mask.shape
    ord_asc = torch.sort(torch.where(mask, labels, INF), dim=-1,
                         stable=True).indices                  # [F, N]
    m = mask.sum(-1)
    trial = mask[:, None, :] & ~_onehot(ord_asc, n)            # [F, r, N]
    rank = torch.arange(n, device=mask.device)[None, :]
    ok = is_contiguous(trial, adj) & (rank < m[:, None])       # member
    pick = _rows(ord_asc, _first_true(ok))
    return torch.where(ok.any(-1), pick, ord_asc[:, 0])


# ---------------------------------------------------------------------------
# head/tail shape evolution
# ---------------------------------------------------------------------------

def _evolve_multi(cfg, statics, mask, labels, centroids, has_boxes):
    """The >= 2-member head/tail swap loop, all cameras at once."""
    f, n = mask.shape
    dev = mask.device
    # members by descending label, ties toward the lower cell id; the
    # order is frozen at loop entry
    order = torch.sort(torch.where(mask, -labels, INF), dim=-1,
                       stable=True).indices
    m = mask.sum(-1)
    done = m < 2
    h_i = torch.zeros(f, dtype=torch.int64, device=dev)
    t_i = torch.clamp(m - 1, min=0)
    thresh = torch.full((f,), cfg.base_threshold, dtype=torch.float32,
                        device=dev)
    failed = torch.zeros(f, dtype=torch.bool, device=dev)
    swaps = torch.zeros(f, dtype=torch.int64, device=dev)

    # every live iteration breaks, advances the head (at most once per
    # swap), or retires a tail — 2n + 2*max_swaps bounds the loop
    for _ in range(2 * n + 2 * cfg.max_swaps):
        done = done | (h_i >= t_i) | (swaps >= cfg.max_swaps)
        if done.all():
            break
        H = _rows(order, torch.clamp(h_i, max=n - 1))
        T = _rows(order, torch.clamp(t_i, 0, n - 1))
        lab_h = _rows(labels, H)
        lab_t = _rows(labels, T)
        live = ~done & (lab_h / torch.clamp(lab_t, min=1e-9) > thresh)
        done = done | (~done & ~live)      # insufficient disparity: break

        scores, cand = _scores(statics, mask, has_boxes, centroids, H)
        has_cand = cand.any(-1)
        best = torch.argmax(torch.where(cand, scores, -INF), dim=-1)

        # no candidate: first failure advances the head, second ends
        nc = live & ~has_cand
        done = done | (nc & failed)
        advance = nc & ~failed
        h_i = torch.where(advance, h_i + 1, h_i)
        thresh = torch.where(advance, cfg.base_threshold, thresh)
        failed = failed | advance

        # candidate: swap if removing the tail keeps the trial contiguous
        wc = live & has_cand
        trial = mask | (_onehot(best, n) & wc[:, None])
        keeps = is_contiguous(trial & ~_onehot(T, n), statics.neighbor8)
        structural = wc & ~keeps
        t_i = torch.where(structural, t_i - 1, t_i)
        swap = wc & keeps
        mask = torch.where(swap[:, None], trial & ~_onehot(T, n), mask)
        failed = failed & ~swap
        swaps = torch.where(swap, swaps + 1, swaps)
        t_i = torch.where(swap, t_i - 1, t_i)
        thresh = torch.where(swap, thresh * cfg.threshold_growth, thresh)
    return mask


def _evolve_single(cfg, statics, mask, labels, centroids, has_boxes):
    """1-member drift/jump branch of the shape evolution."""
    f, n = mask.shape
    H = _first_true(mask)
    lab_h = _rows(labels, H)
    best_global = torch.argmax(labels, dim=-1)
    lab_bg = labels.max(-1).values
    jump = (best_global != H) & (lab_bg > lab_h * 2 * cfg.base_threshold)

    scores, cand = _scores(statics, mask, has_boxes, centroids, H)
    has_cand = cand.any(-1)
    masked = torch.where(cand, scores, -INF)
    best = torch.argmax(masked, dim=-1)
    best_score = masked.max(-1).values
    lab_best = _rows(labels, best)
    moving_away = best_score > 1.05
    promising = lab_best > lab_h * cfg.base_threshold
    drift = ~jump & has_cand & (moving_away | promising)

    target = torch.where(jump, best_global, best)
    move = jump | drift
    moved = (mask & ~_onehot(H, n)) | _onehot(target, n)
    return torch.where(move[:, None], moved, mask)


def evolve_shape(cfg, statics, mask: torch.Tensor, labels: torch.Tensor,
                 centroids: torch.Tensor,
                 has_boxes: torch.Tensor) -> torch.Tensor:
    """All [F, ...]; returns [F, N]. The 1-member branch is evaluated for
    every camera and selected per camera (no host-side branch)."""
    m = mask.sum(-1)
    multi = _evolve_multi(cfg, statics, mask, labels, centroids, has_boxes)
    single = _evolve_single(cfg, statics, mask, labels, centroids,
                            has_boxes)
    out = torch.where((m == 1)[:, None], single, multi)
    return torch.where((m == 0)[:, None], mask, out)


# ---------------------------------------------------------------------------
# resize to the budgeted cell count
# ---------------------------------------------------------------------------

def resize_shape(cfg, statics, mask: torch.Tensor, labels: torch.Tensor,
                 centroids: torch.Tensor, has_boxes: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    """Grow to / shrink to target [F] cells."""
    f, n = mask.shape
    target = torch.clamp(target, 1, n)
    adj_f = statics.neighbor8.to(torch.float32)

    # -- grow: add the best-scored neighbor of the highest-label member
    #    that still has free neighbors. Each live iteration adds a cell
    #    or marks the camera stuck, so n iterations suffice.
    stuck = torch.zeros(f, dtype=torch.bool, device=mask.device)
    for _ in range(n):
        live = ~stuck & (mask.sum(-1) < target)
        if not live.any():
            break
        free = ((~mask).to(torch.float32) @ adj_f) > 0      # any free nbr
        eligible = mask & free
        H = torch.argmax(torch.where(eligible, labels, -INF), dim=-1)
        ok = eligible.any(-1)
        scores, cand = _scores(statics, mask, has_boxes, centroids, H)
        best = torch.argmax(torch.where(cand, scores, -INF), dim=-1)
        grow = live & ok
        mask = mask | (_onehot(best, n) & grow[:, None])
        stuck = stuck | (live & ~ok)

    # -- shrink: drop the lowest-label member whose removal keeps the
    #    shape connected; if none qualifies, drop the lowest regardless.
    #    Each live iteration removes one cell, so n - 1 iterations
    #    suffice.
    for _ in range(n - 1):
        live = mask.sum(-1) > target
        if not live.any():
            break
        T = first_removable(mask, labels, statics.neighbor8)
        mask = mask & ~(_onehot(T, n) & live[:, None])
    return mask


def shape_search_plain(cfg, statics, prev, labels, centroids, has_boxes,
                       max_cells) -> torch.Tensor:
    """Plain version of the shape_search kernel: the evolved shape
    resized to max_cells [F] cells. -> [F, N] bool."""
    evolved = evolve_shape(cfg, statics, prev, labels, centroids,
                           has_boxes)
    return resize_shape(cfg, statics, evolved, labels, centroids,
                        has_boxes, max_cells)


# ---------------------------------------------------------------------------
# reachability: induced-MST preorder walk + shrink to the time budget
# ---------------------------------------------------------------------------

def walk(statics, mask, start):
    """Preorder walk of each camera's shape. mask [F, N] bool, start [F].

    Returns (order [F, N] padded with -1, count [F], path_time_deg [F])
    in degrees (the caller divides by rotation speed)."""
    f, n = mask.shape
    dev = mask.device
    ar = torch.arange(f, device=dev)
    dist = statics.dist
    m = mask.sum(-1)

    masked_d = torch.where(mask, dist[start], INF)
    start2 = torch.where(mask[ar, start], start,
                         torch.argmin(masked_d, dim=-1))
    induced = statics.mst_adj[None] & mask[:, :, None] & mask[:, None, :]
    closure = reach_closure(mask, induced)                    # [F, N, N]

    # stitch the components of the induced forest to start2's component
    # by the cheapest (row-major first) cross edge; each live iteration
    # absorbs one whole component, so n - 1 iterations suffice
    seed = _onehot(start2, n) & mask
    done = (seed[:, :, None] & closure).any(1) & mask
    extra = torch.zeros((f, n, n), dtype=torch.bool, device=dev)
    for _ in range(n - 1):
        rest = mask & ~done
        live = rest.any(-1)
        if not live.any():
            break
        cross = torch.where(done[:, :, None] & rest[:, None, :], dist, INF)
        idx = torch.argmin(cross.reshape(f, n * n), dim=-1)
        u, v = idx // n, idx % n
        done = done | (closure[ar, v] & rest & live[:, None])
        edge = (_onehot(u, n)[:, :, None]
                & _onehot(v, n)[:, None, :]) & live[:, None, None]
        extra = extra | edge | edge.transpose(1, 2)
    tree = induced | extra

    # preorder DFS, children visited nearest-first (ties: lower cell id);
    # the push order is static per grid (statics.nbr_order). Every cell of
    # the tree is pushed once, so n pops empty every stack.
    stack = torch.zeros((f, n + 1), dtype=torch.int64, device=dev)
    stack[:, 0] = start2
    top = (m > 0).to(torch.int64)
    seen = torch.zeros((f, n), dtype=torch.bool, device=dev)
    order = torch.full((f, n), -1, dtype=torch.int64, device=dev)
    cnt = torch.zeros(f, dtype=torch.int64, device=dev)
    slot_ids = torch.arange(n, device=dev)[None, :]
    for _ in range(n):
        live = top > 0
        if not live.any():
            break
        u = _rows(stack, torch.clamp(top - 1, min=0))
        top2 = top - 1
        seen = seen | (_onehot(u, n) & live[:, None])
        order = torch.where(live[:, None] & (slot_ids == cnt[:, None]),
                            u[:, None], order)
        cnt = cnt + live.to(torch.int64)

        row = statics.nbr_order[u]                  # [F, N] push order
        push = (torch.gather(tree[ar, u], 1, row)
                & ~torch.gather(seen, 1, row) & live[:, None])
        slots = torch.where(push, top2[:, None] + torch.cumsum(push, 1) - 1,
                            n)                      # slot n: discarded
        stack = stack.scatter(1, slots, row)
        top = torch.where(live, top2 + push.sum(-1), top)

    ordc = torch.clamp(order, min=0)
    prev = torch.cat([start[:, None], ordc[:, :-1]], dim=1)
    hops = dist[prev, ordc]
    t_deg = torch.where(slot_ids < cnt[:, None], hops, 0.0).sum(-1)
    return order, cnt, t_deg


def budget_walk_plain(cfg, statics, mask, start, labels, budget_s,
                      per_cell):
    """Plain version of the budget_walk kernel: drop cells
    (first_removable) until each camera's walk fits its exploration
    budget. Returns (mask, order, cnt, t). Each live iteration removes
    one cell and a single cell always fits, so n - 1 iterations
    suffice."""
    f, n = mask.shape

    def feasible(mask, cnt, t):
        return (t + per_cell * cnt <= budget_s) | (mask.sum(-1) <= 1)

    order, cnt, t_deg = walk(statics, mask, start)
    t = t_deg / cfg.rotation_speed
    done = feasible(mask, cnt, t)
    for _ in range(n - 1):
        if done.all():
            break
        T = first_removable(mask, labels, statics.neighbor8)
        mask = torch.where(~done[:, None], mask & ~_onehot(T, n), mask)
        o2, c2, td2 = walk(statics, mask, start)
        t2 = td2 / cfg.rotation_speed
        ok = feasible(mask, c2, t2)
        newly = ~done & ok
        order = torch.where(newly[:, None], o2, order)
        cnt = torch.where(newly, c2, cnt)
        t = torch.where(newly, t2, t)
        done = done | ok
    return mask, order, cnt, t
