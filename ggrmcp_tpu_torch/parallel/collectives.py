"""Sharded leaves and the explicit collectives of the mesh
(parallel/mesh.py).

The reference places arrays with `NamedSharding` and lets GSPMD insert
the collectives. Here one process holds every shard of its coordinates:

- `Sharded` is a leaf of per-coordinate tensors, one per mesh
  coordinate in the mesh's flat order. Coordinates that hold the same
  block on the same device share one tensor (a replica costs nothing
  there); distinct blocks never share storage. `quant.kv_map` maps over
  its parts as it maps over a `QuantizedTensor`'s values and scales, so
  the batcher's cache bookkeeping is unchanged. A quantized sharded
  leaf is a `QuantizedTensor` whose `q` and `scale` are each `Sharded`.
- `shard` / `unshard` split a tensor by a spec and put it back;
  `gather_batch` puts the data blocks' rows (`mesh.data_blocks`) back
  in batch order.
- `all_reduce_sum` (after every row-parallel product), `all_gather`
  (of vocab-sharded logits), `ppermute` (the ring shift of ring
  attention's K/V and of a pipeline's activations) and `all_to_all`
  (Ulysses' sequence/head re-shard) move tensors with `.to(device,
  non_blocking=True)`: a no-op between shards on one device, a peer copy
  between cards, so shards on distinct cards compute the same result.
- Across processes (a mesh of parallel/distributed.py's `global_mesh`,
  on which any axis may cross processes) a process holds and computes
  its own coordinates only: a `Sharded` leaf's other parts are None, and
  so is every per-coordinate entry of another process's coordinate. A
  collective over coordinates of several processes combines this
  process's parts as above, then reaches the others' through the
  process group of those processes (`Mesh.groups`, `group_for`).
  Autograd crosses the boundary by Megatron's pair of functions
  (`copy_in`: identity forward, all-reduce backward, for the input a
  split product replicates; the all-reduce of `all_reduce_sum`: the sum
  forward, identity backward, for a row-parallel output), so every
  process of a tensor or expert group holds the whole gradient of what
  it replicates; `all_gather` gives each process its own slice of the
  gradient back; `sum_across` (the sum both ways) is for a quantity
  that processes holding different rows add up, whose loss they share
  out (the MoE aux loss over the global batch); `send` / `recv` carry a
  pipeline hop and, backward, its gradient. `process_sum` and
  `all_reduce_grads` (a train step's gradients, in float32 buckets) sum
  over a group. Under gloo, whose collectives take host tensors, a CUDA
  tensor is staged through host memory explicitly (the gradients
  through one pinned bucket kept from step to step): that is the design
  for processes sharing a card, not a fallback. NCCL (one card a
  process) reduces on the card. Between cards of one process a
  collective is still a peer copy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from ggrmcp_tpu_torch.parallel import mesh as mesh_mod


@dataclasses.dataclass
class Sharded:
    """One leaf as per-coordinate parts. `factors[i]` is how many blocks
    the dim i places from the END of the shape is split into (aligned
    right, so ops that index leading axes keep it true); `shape` is the
    global shape (`full` when given: a split by index, such as the
    fused wqkv with replicated KV heads, need not tile it evenly)."""

    parts: tuple
    factors: tuple[int, ...]
    mesh: Optional[mesh_mod.Mesh] = None
    full: Optional[torch.Size] = None
    # A leaf split by rows into views of whole storages (a cache split
    # by slot over data blocks): per coordinate, the storage its part is
    # a view of, and the dim the views cut, counted from the end as
    # `factors` is (None otherwise).
    bases: Optional[tuple] = None
    batch_dim: Optional[int] = None
    # The adapted spec the leaf was placed by (one entry a dim, the mesh
    # axes that split it), where its placer knows it.
    spec: Optional[tuple] = None

    @property
    def first(self) -> torch.Tensor:
        """The first part this process holds."""
        return next(p for p in self.parts if p is not None)

    @property
    def shape(self) -> torch.Size:
        if self.full is not None:
            return self.full
        local = list(self.first.shape)
        for i, f in enumerate(reversed(self.factors[-len(local):])):
            local[len(local) - 1 - i] *= f
        return torch.Size(local)

    @property
    def dtype(self) -> torch.dtype:
        return self.first.dtype

    def distinct(self) -> list:
        """The parts this process holds, each stored tensor once."""
        return list({id(p): p for p in self.parts
                     if p is not None}.values())

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.distinct())

    def numel(self) -> int:
        return math.prod(self.shape)

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """`fn` over aligned parts, once per distinct tuple of stored
        tensors (an in-place op on a shared replica runs once). A leaf
        with `bases` gives its whole-batch storages instead, so a row
        index means a global slot."""
        done: dict[tuple, Any] = {}
        out = []
        for i, part in enumerate(self.parts):
            if part is None:
                out.append(None)
                continue
            args = tuple(x.bases[i] if x.bases is not None else x.parts[i]
                         for x in (self, *others))
            key = tuple(id(a) for a in args)
            if key not in done:
                done[key] = fn(*args)
            out.append(done[key])
        ndim = next(o for o in out if o is not None).dim()
        factors = self.factors[-ndim:] if ndim else ()
        if self.bases is not None:
            # Mapped over whole storages: the dim the views cut is whole.
            factors = tuple(1 if n - ndim == self.batch_dim else f
                            for n, f in enumerate(factors))
        return Sharded(tuple(out), factors, self.mesh)


def _block_slices(t_shape, spec, mesh, coord, index_fn):
    """The index of coordinate `coord`'s block: one slice per dim, or an
    index tensor from `index_fn(dim, block, n_blocks)` where it gives
    one."""
    idx, key = [], []
    for dim, (size, entry) in enumerate(zip(t_shape, spec)):
        n = mesh_mod.axis_product(mesh, entry)
        b = mesh_mod.block_index(mesh, entry, coord)
        key.append(b)
        custom = index_fn(dim, b, n) if (index_fn and n > 1) else None
        if custom is not None:
            idx.append(custom)
        else:
            step = size // n
            idx.append(slice(b * step, (b + 1) * step))
    return tuple(idx), tuple(key)


def shard(
    t: torch.Tensor, spec: tuple, mesh: mesh_mod.Mesh,
    index_fn: Optional[Callable] = None,
) -> Sharded:
    """Split `t` by `spec` (adapted: every named dim divides) over
    `mesh`, each block copied to its coordinate's device. A dim whose
    blocks are not contiguous ranges takes its indices from
    `index_fn(dim, block, n_blocks)` (the fused wqkv's head-aligned
    columns). A whole, replicated leaf already on a coordinate's device
    is used as it is there, not copied. Another process's coordinates
    get None."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    parts, seen = [], {}
    for i, dev in enumerate(mesh.devices):
        if not mesh.is_local(i):
            parts.append(None)
            continue
        idx, key = _block_slices(t.shape, spec, mesh, mesh.coord(i), index_fn)
        key = (key, dev)
        if key not in seen:
            whole = all(
                isinstance(s, slice) and s == slice(0, n)
                for s, n in zip(idx, t.shape)
            )
            if whole and t.device == dev:
                seen[key] = t
            else:
                block = t[idx]
                seen[key] = torch.empty(
                    block.shape, dtype=t.dtype, device=dev
                ).copy_(block)
        parts.append(seen[key])
    factors = tuple(mesh_mod.axis_product(mesh, e) for e in spec)
    return Sharded(tuple(parts), factors, mesh,
                   t.shape if index_fn is not None else None, spec=spec)


def unshard(
    sh: Sharded, spec: tuple, index_fn: Optional[Callable] = None,
    device=None,
) -> torch.Tensor:
    """The global tensor of a `shard` result (on `device`, default the
    first part's). On a mesh over processes, a collective of every
    process: each block is written by the first coordinate holding it
    and the blocks are summed over the world, in float32."""
    mesh = sh.mesh
    shape = sh.shape
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    device = device or sh.first.device
    if mesh.spans_processes:
        out = torch.zeros(shape, dtype=torch.float32, device=device)
        seen = set()
        for i in range(mesh.size):
            idx, key = _block_slices(shape, spec, mesh, mesh.coord(i),
                                     index_fn)
            if key in seen:
                continue
            seen.add(key)
            if sh.parts[i] is not None:
                out[_on(idx, device)] = sh.parts[i].float().to(device)
        return process_sum(out).to(sh.dtype)
    out = torch.empty(shape, dtype=sh.dtype, device=device)
    for i, part in enumerate(sh.parts):
        idx, _ = _block_slices(shape, spec, mesh, mesh.coord(i), index_fn)
        idx = tuple(s.to(device) if isinstance(s, torch.Tensor) else s
                    for s in idx)
        out[idx] = part.to(device)
    return out


def sum_tied_grads(sh: Sharded, spec: tuple,
                   index_fn: Optional[Callable] = None) -> None:
    """Give each stored part of a trained leaf the whole gradient of the
    blocks it holds. Parts whose blocks overlap (a replica of one block
    on another device; the replicated KV columns every tensor shard of
    the fused wqkv holds when tensor does not divide the KV heads) each
    got only the gradient of their own uses: their `.grad`s are summed
    into the global shape in float32 on the first part's device, in
    shard order, and each part reads its block back. A part no forward
    read has no `.grad` and adds nothing. Parts sharing one stored
    tensor already accumulated into it; disjoint parts are left as they
    are. `spec` is the adapted spec the leaf was sharded by."""
    mesh, shape = sh.mesh, sh.shape
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    held: dict[int, tuple] = {}
    for i, part in enumerate(sh.parts):
        if part is not None and id(part) not in held:
            held[id(part)] = (part, _block_slices(shape, spec, mesh,
                                                  mesh.coord(i), index_fn))
    keys = {key for _, (_, key) in held.values()}
    overlap = len(keys) < len(held)
    if not overlap and index_fn is not None:
        picked = [i for _, (idx, _) in held.values() for i in idx
                  if isinstance(i, torch.Tensor)]
        if picked:
            every = torch.cat([i.flatten() for i in picked])
            overlap = torch.unique(every).numel() < every.numel()
    if not overlap:
        return
    dev = sh.first.device
    total = torch.zeros(shape, dtype=torch.float32, device=dev)
    for part, (idx, _) in held.values():
        if part.grad is not None:
            total[_on(idx, dev)] += part.grad.float().to(dev)
    for part, (idx, _) in held.values():
        part.grad = total[_on(idx, dev)].to(part.device, part.dtype)


def _on(idx, device):
    return tuple(i.to(device) if isinstance(i, torch.Tensor) else i
                 for i in idx)


def gather_batch(blocks: list[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """Data blocks' rows put back in batch order on the first block's
    device (the controller, which samples and takes the loss)."""
    if len(blocks) == 1:
        return blocks[0]
    dev = blocks[0].device
    return torch.cat([b.to(dev, non_blocking=True) for b in blocks], dim=dim)


def local(tree: Any, index: int) -> Any:
    """Coordinate `index`'s view of a tree of sharded leaves: each
    `Sharded` gives its part, a `QuantizedTensor` of sharded values and
    scales gives the pair of parts, anything else passes through."""
    from ggrmcp_tpu_torch.ops.quant import QuantizedTensor

    if isinstance(tree, Sharded):
        return tree.parts[index]
    if isinstance(tree, QuantizedTensor):
        q = local(tree.q, index)
        return None if q is None else QuantizedTensor(
            q=q, scale=local(tree.scale, index))
    if isinstance(tree, dict):
        return {k: local(v, index) for k, v in tree.items()}
    return tree


def replicate(t: torch.Tensor, devices) -> list[torch.Tensor]:
    """`t` on each of `devices`: one copy per distinct device, shared by
    the coordinates on it (`t` itself on its own device); None for a
    None device (another process's coordinate)."""
    copies: dict[torch.device, torch.Tensor] = {}
    out = []
    for dev in devices:
        if dev is None:
            out.append(None)
            continue
        if dev not in copies:
            copies[dev] = t.to(dev, non_blocking=True)
        out.append(copies[dev])
    return out


def per_device(fn: Callable, *lists) -> list:
    """`fn` over aligned per-shard argument lists, once per distinct
    tuple of argument objects: a replicated value shared by two shards
    on one device is computed once. An entry with a None argument
    (another process's shard) gives None."""
    done: dict[tuple, Any] = {}
    out = []
    for args in zip(*lists):
        if any(a is None for a in args):
            out.append(None)
            continue
        key = tuple(id(a) for a in args)
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


def is_split(leaf, dim: int) -> bool:
    """Whether a placed leaf's dim `dim` is split over its mesh (the
    leaves of a whole block hold every row and column everywhere)."""
    leaf = getattr(leaf, "q", leaf)
    return isinstance(leaf, Sharded) and leaf.factors[dim] > 1


def block_product(xs: list, split: bool, product, group=None) -> list:
    """A block's output per shard: `product(i)` of every shard i this
    process holds, summed (a split block's row-parallel partials, over
    `group` too when the shards cross processes), or of a whole block
    once per device, by the first shard on it, with no reduce."""
    if split:
        return all_reduce_sum([None if x is None else product(i)
                               for i, x in enumerate(xs)], group)
    done: dict = {}
    for i, x in enumerate(xs):
        if x is not None and x.device not in done:
            done[x.device] = product(i)
    return [None if x is None else done[x.device] for x in xs]


def all_reduce_sum(parts: list, group=None) -> list:
    """Sum of per-shard partials, added in shard order on the first
    part's device and returned on every part's device (one tensor per
    distinct device). A row-parallel product hands in float32 partials
    and rounds the sum once, as one unsharded product rounds once.
    `group`: the processes holding the other shards (None entries
    here), whose sums are added by an all-reduce whose backward is the
    identity (each process's loss sees the whole sum)."""
    held = [p for p in parts if p is not None]
    dev = held[0].device
    total = held[0]
    for p in held[1:]:
        total = total + p.to(dev, non_blocking=True)
    if group is not None:
        total = _ReduceOut.apply(total, group)
    return replicate(total, [None if p is None else p.device for p in parts])


# -- process groups ------------------------------------------------------------


def group_for(mesh: mesh_mod.Mesh, ranks) -> Optional[Any]:
    """The process group of `ranks` on `mesh`, None for this process
    alone. A set no group was formed for raises: nothing runs on one
    process instead."""
    ranks = tuple(ranks)
    if len(ranks) <= 1:
        return None
    if not mesh.groups or ranks not in mesh.groups:
        raise RuntimeError(
            f"no process group for processes {list(ranks)}: a mesh over "
            f"processes comes from distributed.global_mesh, which forms "
            f"the groups its collectives span")
    return mesh.groups[ranks]


def axis_group(mesh: mesh_mod.Mesh, axes) -> Optional[Any]:
    """The group of a collective over `axes` from this process."""
    return group_for(mesh, mesh_mod.axis_ranks(mesh, axes))


def coords_group(mesh: mesh_mod.Mesh, coords) -> Optional[Any]:
    """The group of the processes owning `coords`."""
    return group_for(mesh, mesh_mod.coord_ranks(mesh, coords))


class _CopyIn(torch.autograd.Function):
    """Identity forward, the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return process_sum(grad, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """The sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return process_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SumAcross(torch.autograd.Function):
    """The sum over the group forward and backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return process_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return process_sum(grad, ctx.group), None


class _GatherAcross(torch.autograd.Function):
    """The group's tensors concatenated along `dim` in rank order
    forward; this process's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = torch.distributed.get_world_size(group)
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.index = torch.distributed.get_rank(group)
        src = x.detach().contiguous()
        src = src.cpu() if _staged(x) else src
        parts = [torch.empty_like(src) for _ in range(n)]
        torch.distributed.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def process_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every process of `group`'s `t`, stacked in rank order on `t`'s
    device (no gradient)."""
    with torch.no_grad():
        return _GatherAcross.apply(t[None], 0, group)


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """`x` as the input of a product split over `group`'s processes:
    the same tensor forward; backward, its gradient summed over the
    group, so each process holds the gradient of every shard's use."""
    return x if group is None else _CopyIn.apply(x, group)


def sum_across(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over `group`, its gradient summed back over it: for a
    sum of rows the processes hold apart, each process's loss carrying
    its share."""
    return x if group is None else _SumAcross.apply(x, group)


class _Send(torch.autograd.Function):
    """Forward: `x` sent to process `dst`; returns a zero scalar whose
    backward receives the gradient of `x` that `dst` sends back."""

    @staticmethod
    def forward(ctx, x, dst, tag):
        ctx.dst, ctx.tag = dst, tag
        ctx.meta = (x.shape, x.dtype, x.device)
        _p2p(x.detach(), dst, tag, send=True)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _grad):
        shape, dtype, device = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        _p2p(grad, ctx.dst, ctx.tag, send=False)
        return grad, None, None


class _Recv(torch.autograd.Function):
    """Forward: the [shape] `dtype` tensor process `src` sends, on
    `anchor`'s device; backward, its gradient sent back to `src` without
    waiting (`wait_sends`), so no order of the backward's hops can
    block two processes on each other."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, tag):
        ctx.src, ctx.tag = src, tag
        out = torch.empty(shape, dtype=dtype, device=anchor.device)
        _p2p(out, src, tag, send=False)
        return out

    @staticmethod
    def backward(ctx, grad):
        host = grad.detach().contiguous()
        host = host.cpu() if _staged(host) else host
        _pending.append((torch.distributed.isend(host, ctx.src,
                                                 tag=ctx.tag), host))
        return None, None, None, None, None


# The backward's sends in flight, and the buffers they read.
_pending: list = []


def wait_sends() -> None:
    """Wait for every send the backward started (`recv`'s gradients)."""
    while _pending:
        work, _ = _pending.pop(0)
        work.wait()


def _p2p(t: torch.Tensor, peer: int, tag: int, send: bool) -> None:
    """A blocking send of `t` to, or receive into `t` from, process
    `peer` (staged through host memory under gloo)."""
    dist = torch.distributed
    if not _staged(t):
        (dist.send if send else dist.recv)(t, peer, tag=tag)
        return
    host = t.detach().cpu() if send else torch.empty(
        t.shape, dtype=t.dtype)
    (dist.send if send else dist.recv)(host, peer, tag=tag)
    if not send:
        t.copy_(host)


def send(x: torch.Tensor, dst: int, tag: int) -> torch.Tensor:
    """Send `x` to process `dst` (a pipeline hop). Returns a zero scalar
    to add into this process's loss: backward through it receives the
    gradient of `x` from `dst` and carries it on."""
    return _Send.apply(x, dst, tag)


def recv(anchor: torch.Tensor, shape, dtype, src: int,
         tag: int) -> torch.Tensor:
    """The [shape] `dtype` tensor process `src` sends with `tag`, on
    `anchor`'s device; backward sends its gradient back to `src`.
    `anchor`, a scalar that requires grad, puts the receive in the
    graph."""
    return _Recv.apply(anchor, tuple(shape), dtype, src, tag)


def _staged(t: torch.Tensor) -> bool:
    """Whether `t` goes through host memory for the group's collectives
    (gloo's take host tensors)."""
    return (t.device.type == "cuda"
            and torch.distributed.get_backend() == "gloo")


def process_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """`t` summed over `group` (default every process), in float32
    (staged through host memory under gloo), returned in `t`'s dtype on
    its device, detached; `t` is not written."""
    buf = t.detach().float()
    buf = buf.cpu() if _staged(t) else buf.clone()
    if group is None:
        torch.distributed.all_reduce(buf)
    else:
        torch.distributed.all_reduce(buf, group=group)
    return buf.to(t.device, t.dtype)


# Elements of one float32 bucket of `all_reduce_grads` (256 MiB).
GRAD_BUCKET = 1 << 26

# (device, staged) -> the float32 bucket buffer `all_reduce_grads` reuses
# from step to step: pinned host memory when staged, so that the copies
# to and from the card are DMA and no step allocates one.
_buckets: dict = {}


def _bucket_buffer(n: int, device: torch.device,
                   staged: bool) -> torch.Tensor:
    key = (str(device), staged)
    buf = _buckets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32,
                          device="cpu" if staged else device,
                          pin_memory=staged)
        _buckets[key] = buf
    return buf


def all_reduce_grads(tensors: list[torch.Tensor], group=None) -> None:
    """Sum the `.grad` of each tensor over `group` (default every
    process), in place.
    The grads, in order, are read as one stream of float32 elements
    through a bucket buffer of GRAD_BUCKET elements (a grad may span
    buckets), kept from call to call; each full bucket is all-reduced
    once and written back into the grads in their own dtype. Under gloo
    the buffer is pinned host memory (the staging of CUDA grads); on the
    CPU, or under NCCL, it lies on the grads' device. Every process
    passes the same tensors in the same order; a tensor without a grad
    (none in any process, the same program running everywhere) is left
    out."""
    grads = [t.grad for t in tensors if t.grad is not None]
    if not grads:
        return
    staged = _staged(grads[0])
    flats = [g.view(-1) if g.is_contiguous() else g.contiguous().view(-1)
             for g in grads]
    size = min(sum(f.numel() for f in flats), GRAD_BUCKET)
    buf = _bucket_buffer(size, grads[0].device, staged)[:size]
    pieces: list = []  # (flat, start, bucket offset, length)
    used = 0
    for flat in flats:
        start = 0
        while start < flat.numel():
            n = min(flat.numel() - start, buf.numel() - used)
            buf[used:used + n].copy_(flat[start:start + n],
                                     non_blocking=staged)
            pieces.append((flat, start, used, n))
            used, start = used + n, start + n
            if used == buf.numel():
                _reduce_bucket(buf, used, pieces, staged, group)
                pieces, used = [], 0
    if used:
        _reduce_bucket(buf, used, pieces, staged, group)
    for g, flat in zip(grads, flats):
        if flat.data_ptr() != g.data_ptr():
            g.copy_(flat.view_as(g))


def _reduce_bucket(buf: torch.Tensor, used: int, pieces: list,
                   staged: bool, group=None) -> None:
    """All-reduce the bucket's first `used` elements and copy each piece
    back. Staged: the copies into the pinned buffer are waited for
    before gloo reads it; the copies back are queued on the stream, which
    orders them before the next bucket's copies into the buffer."""
    if staged:
        torch.cuda.current_stream(pieces[0][0].device).synchronize()
    if group is None:
        torch.distributed.all_reduce(buf[:used])
    else:
        torch.distributed.all_reduce(buf[:used], group=group)
    for flat, start, off, n in pieces:
        flat[start:start + n].copy_(buf[off:off + n], non_blocking=staged)


def all_gather(parts: list, dim: int, group=None) -> torch.Tensor:
    """Per-shard blocks concatenated along `dim` on the first part's
    device (the controller, which samples). `group`: the processes
    holding the other blocks (None entries here, the same count each),
    whose concatenations join in rank order; backward, each process
    keeps its own blocks' slice of the gradient (every process's loss
    sees the whole tensor)."""
    held = [p for p in parts if p is not None]
    dev = held[0].device
    out = torch.cat([p.to(dev, non_blocking=True) for p in held], dim=dim)
    return out if group is None else _GatherAcross.apply(out, dim, group)


def ppermute(parts: list, devices: Optional[list] = None) -> list:
    """The ring shift `jax.lax.ppermute` with perm [(i, (i + 1) % n)]:
    shard i receives shard (i - 1) mod n's tensor, on shard i's device
    (`devices[i]`, default the part's own). A None part (a pipeline
    stage with nothing to send this tick) arrives as None."""
    n = len(parts)
    devices = devices or [p.device for p in parts]
    return [None if parts[(i - 1) % n] is None
            else parts[(i - 1) % n].to(devices[i], non_blocking=True)
            for i in range(n)]


def all_to_all(parts: list, split_dim: int, concat_dim: int) -> list:
    """The tiled `jax.lax.all_to_all`: each shard's tensor is split into
    n blocks along `split_dim`; shard j receives block j of every shard,
    concatenated in shard order along `concat_dim`, on its own device."""
    n = len(parts)
    blocks = [p.chunk(n, dim=split_dim) for p in parts]
    return [torch.cat([blocks[i][j].to(parts[j].device, non_blocking=True)
                       for i in range(n)], dim=concat_dim)
            for j in range(n)]
