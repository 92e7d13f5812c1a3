"""X1: the per-ray stackless walk of a threaded BVH.

Counterpart of experiments/trace_wavefront.py, whose Pallas kernel
`walk_leaves` (:158, pallas_call :167) gives each ray the leaves it
enters, in walk order. The TPU kernel lost to the packet kernels (91 ms
for 71k rays on a v5e, that module's docstring); on the card each thread
walks its own ray, which is what a GPU's traversal does, and the walk is
the starting point ROADMAP.md names for a Hopper traversal.

- `pack_threaded(bvh)`: the preorder/skip table, a copy of
  experiments/trace_wavefront.py:242 over the port's accel/bvh.Bvh, bit
  for bit the same table.
- `walk_leaves(table, ray_o, ray_d, t_max, l_cap)`: the kernel's wrapper
  (csrc/trace_wavefront.cu `walk_kernel`); on CPU tensors its plain
  version `walk_leaves_plain`, a lockstep walk of all rays at once. The
  kernel restages the table node-major, 32 bytes a node; `walk_path`
  says where: in a block's shared memory ("shared") when it fits, else
  in a device-memory copy the wrapper allocates ("global").

A ray enters a node when enter <= exit and enter < t_max (the slab test
of ops/intersect.slab_enter_exit, 1/d = 1e30 where |d| <= 1e-12); a ray
with t_max <= 0 is dead. Leaves come back as (R, l_cap) int32, -1
after the ray's last, and counts (R,) int32 that keep counting past
l_cap (count > l_cap: the list overflowed).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.bvh import Bvh
from ..ops.intersect import safe_inv_dir, slab_enter_exit
from ..ops.trace_bvh import as_tmax, expect_tensor

L_CAP = 32  # per-ray leaf list capacity (experiments/trace_wavefront.py:47)
CHUNK = 128  # nodes per table chunk
NODE_BYTES = 32  # a node restaged node-major: two float4s
SHARED_BYTES_MAX = 232_448  # dynamic shared memory a block takes on sm_90


def pack_threaded(bvh: Bvh) -> np.ndarray:
    """Preorder threaded node table of a max_leaf_size == 1 BVH.

    Returns (n_chunks, 8, 128) f32: chunk c, field row f, node lane l is
    field f of preorder node c*128+l. Field rows: [min.x, min.y, min.z,
    max.x, max.y, max.z, skip, leaf]. On a box hit the walk goes to
    node + 1 (the preorder first child; a leaf's subtree is itself), on a
    miss to skip (the first node after the subtree); n_chunks * 128 ends
    it. skip and leaf are exact f32 integers (N < 2^24). The padding
    nodes have NaN bounds, never entered, and skip to the end."""
    assert bvh.nodes_count.max() <= 1
    n = bvh.n_nodes
    n_chunks = -(-n // CHUNK)
    n_term = n_chunks * CHUNK
    # subtree sizes, bottom-up over a preorder list
    sizes = np.ones(n, np.int64)
    order_stack, post = [0], []
    while order_stack:
        i = order_stack.pop()
        post.append(i)
        if bvh.nodes_count[i] == 0:
            order_stack.append(bvh.nodes_left[i])
            order_stack.append(bvh.nodes_right[i])
    for i in reversed(post):
        if bvh.nodes_count[i] == 0:
            sizes[i] = 1 + sizes[bvh.nodes_left[i]] + sizes[bvh.nodes_right[i]]
    # preorder positions; a node's skip is the position after its subtree
    pre = np.empty(n, np.int32)
    skip = np.empty(n, np.int32)
    pos = 0
    stack = [(0, n_term)]
    while stack:
        i, after = stack.pop()
        pre[i] = pos
        skip[pos] = after
        pos += 1
        if bvh.nodes_count[i] == 0:
            left, right = bvh.nodes_left[i], bvh.nodes_right[i]
            stack.append((right, after))
            stack.append((left, pos + int(sizes[left])))
    inv = np.empty(n, np.int32)
    inv[pre] = np.arange(n, dtype=np.int32)  # preorder position -> node
    leaf = np.where(
        bvh.nodes_count[inv] > 0, bvh.order[bvh.nodes_first[inv]], -1
    )
    flat = np.concatenate(
        [
            bvh.nodes_min[inv],
            bvh.nodes_max[inv],
            skip[:, None].astype(np.float32),
            leaf[:, None].astype(np.float32),
        ],
        axis=1,
    )  # (n, 8)
    if n_term > n:
        term = np.zeros((n_term - n, 8), np.float32)
        term[:, 0:6] = np.nan
        term[:, 6] = n_term
        term[:, 7] = -1
        flat = np.concatenate([flat, term], axis=0)
    return np.ascontiguousarray(
        flat.reshape(n_chunks, CHUNK, 8).transpose(0, 2, 1), np.float32)


def walk_plain(table, ray_o, ray_d, t_max, l_cap: int = L_CAP):
    """The walk in PyTorch, all rays in lockstep: each step, every ray
    still walking tests its current node. Returns (leaves, counts,
    steps), steps (R,) int64 the nodes each ray tested."""
    dev = ray_o.device
    R = ray_o.shape[0]
    tab = table.transpose(1, 2).reshape(-1, 8)
    n_nodes = tab.shape[0]
    t_max = as_tmax(t_max, R, dev)
    inv = safe_inv_dir(ray_d)
    leaves = torch.full((R, l_cap), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros(R, dtype=torch.int64, device=dev)
    steps = torch.zeros(R, dtype=torch.int64, device=dev)
    cur = torch.where(t_max > 0.0, 0, n_nodes).to(torch.int64)
    a = torch.nonzero(cur < n_nodes).flatten()
    while a.numel():
        f = tab[cur[a]]
        enter, exit_ = slab_enter_exit(ray_o[a], inv[a], f[:, 0:3], f[:, 3:6])
        hit = (enter <= exit_) & (enter < t_max[a])
        leaf = f[:, 7].to(torch.int64)
        at = hit & (leaf >= 0)
        slot = counts[a]
        put = at & (slot < l_cap)
        leaves[a[put], slot[put]] = leaf[put].to(torch.int32)
        counts[a] += at.to(torch.int64)
        steps[a] += 1
        cur[a] = torch.where(hit, cur[a] + 1, f[:, 6].to(torch.int64))
        a = a[cur[a] < n_nodes]
    return leaves, counts.to(torch.int32), steps


def walk_leaves_plain(table, ray_o, ray_d, t_max, l_cap: int = L_CAP):
    """Plain walk -> (leaves (R, l_cap) int32, counts (R,) int32)."""
    leaves, counts, _ = walk_plain(table, ray_o, ray_d, t_max, l_cap)
    return leaves, counts


def walk_path(n_chunks: int) -> str:
    """Where the kernel walks a table of n_chunks chunks: "shared" when
    its node-major copy fits a block's shared memory (up to 56 chunks),
    else "global" (a node-major copy in device memory)."""
    fits = n_chunks * CHUNK * NODE_BYTES <= SHARED_BYTES_MAX
    return "shared" if fits else "global"


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


def walk_leaves(table, ray_o, ray_d, t_max, l_cap: int = L_CAP):
    """Each ray's entered leaves in walk order -> (leaves (R, l_cap)
    int32, -1 padding; counts (R,) int32, count > l_cap: overflow).

    table (n_chunks, 8, 128) f32 from pack_threaded; ray_o, ray_d (R, 3)
    f32; t_max scalar or (R,)."""
    dev = ray_o.device
    R = ray_o.shape[0]
    if dev.type == "cpu":
        return walk_leaves_plain(table, ray_o, ray_d, t_max, l_cap)
    if dev.type != "cuda":
        raise ValueError(f"walk_leaves: unsupported device {dev}")
    from ..ops import cuda_build

    t_max = as_tmax(t_max, R, dev)
    expect_tensor(table, "table", torch.float32, dev, (None, 8, CHUNK))
    expect_tensor(ray_o, "ray_o", torch.float32, dev, (R, 3))
    expect_tensor(ray_d, "ray_d", torch.float32, dev, (R, 3))
    if l_cap < 1:
        raise ValueError(f"walk_leaves: l_cap must be >= 1, got {l_cap}")
    n_chunks = table.shape[0]
    leaves = torch.empty((R, l_cap), dtype=torch.int32, device=dev)
    counts = torch.empty((R,), dtype=torch.int32, device=dev)
    nodes = (torch.empty((2, n_chunks * CHUNK, 4), dtype=torch.float32,
                         device=dev)
             if walk_path(n_chunks) == "global" else None)
    cuda_build.launch("trace_wavefront", "walk_leaves", _ARGTYPES, dev, (
        table.data_ptr(), n_chunks, ray_o.data_ptr(), ray_d.data_ptr(),
        t_max.data_ptr(), R, int(l_cap), leaves.data_ptr(),
        counts.data_ptr(), 0 if nodes is None else nodes.data_ptr()))
    walk_leaves.launches += 1
    return leaves, counts


walk_leaves.launches = 0
KERNELS = (walk_leaves,)
