"""Ring attention: sequence (context) parallelism over the mesh's ``seq``
axis.

Counterpart of the JAX package's `parallel/ring.py`. Each rank of the
``seq`` group holds a sequence shard of Q, K and V; K and V (and the key
mask) travel around the ring while each rank accumulates its queries'
attention, so a rank's memory is O(T / S) in the sequence length.
Causality across shards falls out of global offsets: rank i's queries
start at i * T_loc, and the block it holds at ring step s came from rank
(i - s) mod S, so its keys start at ((i - s) mod S) * T_loc.

Where the reference rotates with `ppermute` inside `shard_map`, the port
runs one process per rank and rotates with point-to-point sends
(`Ring.shift`) inside an autograd Function (`_Rotate`): the forward sends
to rank (i + 1) mod S and receives from (i - 1) mod S, the backward sends
the cotangents the other way, and both transfers of a shift are posted
together so no ring can deadlock. On a NCCL group the sends carry the
device tensors; on a gloo group CUDA tensors go through pinned host
buffers (gloo's send/recv does not take device memory), CPU tensors as
they are. The route depends on the group's backend alone and is counted
in `TRANSFERS` with the bytes and the seconds.

`ring_self_attention` is the online-softmax ring (dropout included);
`ring_flash_self_attention` runs the flash forward per shard pair with
`return_lse=True` (the Hopper kernel on a CUDA tensor, its plain version
on a CPU one) and merges the pairs by their LSEs, so the backward kernels
see the merge's LSE cotangent. `make_ring_attention` wraps the ring for
global (B, T, H, D) tensors as the reference's `shard_map` does;
`blockwise_attention` is the one-device form of the same accumulation.
"""
from __future__ import annotations

import math
import threading
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.mesh import SEQ_AXIS, all_gather_dim

NEG = -1e30

#: the rotations' traffic: shifts by route ("nccl", "gloo_host": CUDA
#: tensors through pinned host memory, "gloo": CPU tensors), bytes sent
#: by this rank, and the seconds the shifts took on the host's clock
TRANSFERS = {"shifts": 0, "bytes": 0, "seconds": 0.0, "routes": {}}
_TRANSFER_LOCK = threading.Lock()


def reset_transfers():
    with _TRANSFER_LOCK:
        TRANSFERS.update(shifts=0, bytes=0, seconds=0.0, routes={})


class Ring:
    """A process group seen as a ring: this rank's place `index` in it,
    its `size`, and the global ranks of its neighbours. A ring of one
    rank (or no group) shifts nothing."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, int(index), int(size)
        if self.size > 1:
            self.next = dist.get_global_rank(group, (self.index + 1)
                                             % self.size)
            self.prev = dist.get_global_rank(group, (self.index - 1)
                                             % self.size)
            self.backend = str(dist.get_backend(group))

    @classmethod
    def of(cls, mesh, axis: str = SEQ_AXIS) -> "Ring":
        return cls(mesh.group(axis), mesh.index(axis), mesh.shape[axis])

    def route(self, device: torch.device) -> str:
        if self.backend == "nccl":
            return "nccl"
        return "gloo_host" if device.type == "cuda" else "gloo"

    def shift(self, tensors: List[torch.Tensor], step: int = 1
              ) -> List[torch.Tensor]:
        """Each tensor of this rank goes to rank index + step (mod size);
        the result holds those of rank index - step. One message each
        way, the tensors packed as bytes; both posted together."""
        if self.size == 1 or not tensors:
            return list(tensors)
        t0 = time.perf_counter()
        dst, src = (self.next, self.prev) if step > 0 \
            else (self.prev, self.next)
        parts = [t.contiguous().reshape(-1).view(torch.uint8)
                 for t in tensors]
        # each part starts on an 8-byte boundary, so its bytes view back
        # as its dtype in place
        spans = [-(-p.numel() // 8) * 8 for p in parts]
        packed = torch.cat([torch.nn.functional.pad(p, (0, n - p.numel()))
                            if n != p.numel() else p
                            for p, n in zip(parts, spans)])
        route = self.route(packed.device)
        if route == "gloo_host":
            out_buf = torch.empty(packed.shape, dtype=torch.uint8,
                                  pin_memory=True)
            out_buf.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(packed.device).synchronize()
            in_buf = torch.empty(packed.shape, dtype=torch.uint8,
                                 pin_memory=True)
        else:
            out_buf, in_buf = packed, torch.empty_like(packed)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out_buf, dst, self.group),
            dist.P2POp(dist.irecv, in_buf, src, self.group)])
        for r in reqs:
            r.wait()
        if route == "gloo_host":
            in_buf = in_buf.to(packed.device)
        out, ofs = [], 0
        for t, p, n in zip(tensors, parts, spans):
            out.append(in_buf[ofs:ofs + p.numel()].view(t.dtype)
                       .view(t.shape))
            ofs += n
        with _TRANSFER_LOCK:
            TRANSFERS["shifts"] += 1
            TRANSFERS["bytes"] += int(packed.numel())
            TRANSFERS["seconds"] += time.perf_counter() - t0
            routes = TRANSFERS["routes"]
            routes[route] = routes.get(route, 0) + 1
        return out


class _Rotate(torch.autograd.Function):
    """Forward: the tensors shift one place around the ring. Backward: the
    cotangents of the first `n_diff` shift one place back; the rest (the
    key mask) carry no gradient."""

    @staticmethod
    def forward(ctx, ring, n_diff, *tensors):
        ctx.ring, ctx.n_diff = ring, n_diff
        out = ring.shift(list(tensors), 1)
        ctx.mark_non_differentiable(*out[n_diff:])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n_diff
        back = ctx.ring.shift([g.contiguous() for g in grads[:n]], -1)
        return (None, None, *back, *([None] * (len(grads) - n)))


def rotate(ring: Ring, tensors, mask=None):
    """The previous rank's `tensors` (differentiable) and `mask` (no
    gradient) around the ring: (list of tensors, mask)."""
    if ring.size == 1:
        return list(tensors), mask
    n = len(tensors)
    out = _Rotate.apply(ring, n, *tensors,
                        *(() if mask is None else (mask,)))
    return list(out[:n]), (None if mask is None else out[n])


def _active_ring(ring: Optional[Ring]) -> Ring:
    if ring is not None:
        return ring
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        active_context_parallel,
    )
    cp = active_context_parallel()
    if cp is None:
        raise ValueError("no ring: pass ring= or run inside "
                         "nn.layers.attention.context_parallel")
    return cp.ring


def _online_block(q, k, v, o, m, l, *, causal, q_start, k_start, scale,
                  mask_block=None, dropout=0.0, generator=None):
    """One blockwise online-softmax update.

    q (B, Tq, H, D); k, v (B, Tk, H, D); o (B, Tq, H, D) the running
    numerator; m (B, H, Tq) the running max; l (B, H, Tq) the running
    denominator. Attention dropout applies to the numerator only (l keeps
    every key), which equals dropping the normalized weights."""
    acc_t = o.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc_t), k.to(acc_t)) \
        * scale
    neg = torch.full_like(scores, NEG)
    if causal:
        qpos = q_start + torch.arange(q.shape[1], device=q.device)
        kpos = k_start + torch.arange(k.shape[1], device=q.device)
        scores = torch.where((qpos[:, None] >= kpos[None, :])[None, None],
                             scores, neg)
    if mask_block is not None:
        scores = torch.where(mask_block[:, None, None, :].bool(), scores,
                             neg)
    m_new = torch.maximum(m, scores.amax(dim=-1))             # (B, H, Tq)
    # a fully-masked row: exp(neg - neg) would be 1 and poison l
    alive = m_new > NEG / 2
    corr = torch.where(alive, torch.exp(m - m_new), torch.zeros_like(m))
    p = torch.where(alive[..., None], torch.exp(scores - m_new[..., None]),
                    torch.zeros_like(scores))
    l_new = l * corr + p.sum(dim=-1)
    p_num = p
    if dropout > 0.0 and generator is not None:
        from deeplearning4j_tpu_torch.nn.conf.base import uniform
        keep = 1.0 - dropout
        p_num = p * (uniform(p.shape, generator, p.device) < keep) / keep
    o_new = o * corr.permute(0, 2, 1)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p_num, v.to(acc_t))
    return o_new, m_new, l_new


def _start(b, t, h, d, acc_t, device):
    return (torch.zeros((b, t, h, d), dtype=acc_t, device=device),
            torch.full((b, h, t), -math.inf, dtype=acc_t, device=device),
            torch.zeros((b, h, t), dtype=acc_t, device=device))


def ring_self_attention(q, k, v, *, ring: Optional[Ring] = None,
                        causal: bool = True, mask=None,
                        dropout: float = 0.0, generator=None):
    """Sequence-sharded attention on this rank's shard.

    q, k, v: the local shard (B, T_local, H, D); mask: the local (B,
    T_local) key mask or None; `ring`: the ``seq`` ring (default: the
    active `context_parallel`'s). Returns the local output shard."""
    ring = _active_ring(ring)
    b, t_loc, h, d = q.shape
    acc_t = torch.promote_types(torch.float32, q.dtype)
    scale = 1.0 / math.sqrt(d)
    q_start = ring.index * t_loc
    o, m, l = _start(b, t_loc, h, d, acc_t, q.device)
    k_cur, v_cur, mask_cur = k, v, mask
    for s in range(ring.size):
        src = (ring.index - s) % ring.size
        o, m, l = _online_block(
            q, k_cur, v_cur, o, m, l, causal=causal, q_start=q_start,
            k_start=src * t_loc, scale=scale, mask_block=mask_cur,
            dropout=dropout, generator=generator)
        if s + 1 < ring.size:
            (k_cur, v_cur), mask_cur = rotate(ring, (k_cur, v_cur),
                                              mask_cur)
    out = o / l.permute(0, 2, 1)[..., None].clamp_min(1e-30)
    return out.to(q.dtype)


def ring_flash_self_attention(q, k, v, *, ring: Optional[Ring] = None,
                              causal: bool = True, mask=None,
                              block_q: int = 128, block_k: int = 128):
    """Ring attention with the flash kernels per shard pair
    (`ops/flash_attention.py`), merged across ring steps by the exact
    LSE rule. The diagonal pair (step 0) is locally causal, earlier
    shards attend fully, later ones are computed and then excluded by
    the merge weights, as the reference does. The LSE is differentiable,
    so the merge trains exactly. No dropout (the kernels draw none).

    A pair with no live key (fully masked, or excluded) weighs 0, so a
    query row with no live key anywhere gives 0, as dense attention and
    `ring_self_attention` give; the reference's merge gives such a row
    weight 1 per dead pair, which lets an excluded pair's output in. The
    merge runs in f32 (f64 for f64 inputs)."""
    from deeplearning4j_tpu_torch.ops.flash_attention import flash_attention
    ring = _active_ring(ring)
    b, t_loc, h, d = q.shape
    acc_t = torch.promote_types(torch.float32, q.dtype)
    # unnormalized accumulation, one divide at the end: num = sum_s o_s
    # w_s, z = sum_s w_s, w_s = exp(lse_s - m_acc) as the running max moves
    num = torch.zeros((b, t_loc, h, d), dtype=acc_t, device=q.device)
    z = torch.zeros((b, t_loc, h), dtype=acc_t, device=q.device)
    m_acc = torch.full((b, t_loc, h), NEG, dtype=acc_t, device=q.device)
    k_cur, v_cur, mask_cur = k, v, mask
    for s in range(ring.size):
        src = (ring.index - s) % ring.size
        o_s, l_s = flash_attention(q, k_cur, v_cur, mask=mask_cur,
                                   causal=causal and s == 0,
                                   block_q=block_q, block_k=block_k,
                                   return_lse=True)
        l_s = l_s.to(acc_t)
        if causal and s > 0 and src > ring.index:
            # shard `src` lies wholly in this rank's future: excluded
            l_s = torch.full_like(l_s, NEG)
        m_new = torch.maximum(m_acc, l_s)
        corr = torch.exp(m_acc - m_new)
        w_s = torch.where(l_s > NEG / 2, torch.exp(l_s - m_new),
                          torch.zeros_like(l_s))
        num = num * corr[..., None] + w_s[..., None] * o_s.to(acc_t)
        z = z * corr + w_s
        m_acc = m_new
        if s + 1 < ring.size:
            (k_cur, v_cur), mask_cur = rotate(ring, (k_cur, v_cur),
                                              mask_cur)
    out = num / z.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


class _ShardSeq(torch.autograd.Function):
    """Forward: this rank's piece of dim 1. Backward: the pieces'
    cotangents gathered whole (every rank holds the global gradient)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        n = x.shape[1] // ring.size
        return x.narrow(1, ring.index * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), 1, ctx.ring.group,
                              ctx.ring.size), None


class _GatherSeq(torch.autograd.Function):
    """Forward: the ranks' pieces joined along dim 1. Backward: this
    rank's piece of the cotangent (each rank computes the same loss of
    the whole)."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return all_gather_dim(x.contiguous(), 1, ring.group, ring.size)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[1] // ctx.ring.size
        return g.narrow(1, ctx.ring.index * n, n).contiguous(), None


def make_ring_attention(mesh, *, causal: bool = True,
                        axis_name: str = SEQ_AXIS):
    """Ring attention for global (B, T, H, D) views, as the reference's
    `shard_map` wrapper appears to its caller: every rank passes the
    whole q, k, v (and (B, T) mask), takes its piece along T, runs
    `ring_self_attention`, and gets the whole output back; gradients
    with respect to the whole inputs are whole on every rank."""
    ring = Ring.of(mesh, axis_name)
    size = ring.size

    def attend(q, k, v, mask=None):
        from deeplearning4j_tpu_torch import monitor
        t = q.shape[1]
        if t % size:
            raise ValueError(f"sequence length {t} not divisible by "
                             f"{axis_name} degree {size}")
        nbytes = (lambda a: 0 if a is None
                  else a.numel() * a.element_size() // size)
        monitor.counter("ring_attention_calls_total",
                        "ring attention invocations (trace-time under "
                        "jit)").inc()
        monitor.counter("ring_bytes_rotated_total",
                        "K/V (+mask) bytes scheduled over the ring per "
                        "call (trace-time under jit: counts traced "
                        "builds, not executed steps)").inc(
            (size - 1) * (nbytes(k) + nbytes(v) + nbytes(mask)))
        with monitor.span("parallel/ring_attention", seq_shards=size):
            if size == 1:
                return ring_self_attention(q, k, v, ring=ring,
                                           causal=causal, mask=mask)
            ql, kl, vl = (_ShardSeq.apply(a, ring) for a in (q, k, v))
            ml = None if mask is None else \
                mask.narrow(1, ring.index * (t // size), t // size)
            out = ring_self_attention(ql, kl, vl, ring=ring, causal=causal,
                                      mask=ml)
            return _GatherSeq.apply(out, ring)

    return attend


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = True, mask=None,
                        dropout: float = 0.0, generator=None):
    """One device's memory-efficient attention: the ring's online-softmax
    accumulation over local K/V blocks, O(T * block) memory instead of
    O(T^2)."""
    b, t, h, d = q.shape
    if t % block_size:
        raise ValueError(f"sequence {t} not divisible by block {block_size}")
    acc_t = torch.promote_types(torch.float32, q.dtype)
    scale = 1.0 / math.sqrt(d)
    o, m, l = _start(b, t, h, d, acc_t, q.device)
    for s in range(t // block_size):
        sl = slice(s * block_size, (s + 1) * block_size)
        o, m, l = _online_block(
            q, k[:, sl], v[:, sl], o, m, l, causal=causal, q_start=0,
            k_start=s * block_size, scale=scale,
            mask_block=None if mask is None else mask[:, sl],
            dropout=dropout, generator=generator)
    out = o / l.permute(0, 2, 1)[..., None].clamp_min(1e-30)
    return out.to(q.dtype)
